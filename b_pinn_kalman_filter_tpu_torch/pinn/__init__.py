"""PINN and B-PINN flow inference (forward only so far; training comes
with a later slice)."""
