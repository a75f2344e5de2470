"""Square-root UKF over patch states, Navier–Stokes dynamics and the
B-PINN measurement loop."""
