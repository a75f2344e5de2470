"""Score networks.  Importing the package registers the models."""

from b_pinn_kalman_filter_tpu_torch.models import ddpm, ncsnpp  # noqa: F401
from b_pinn_kalman_filter_tpu_torch.models.registry import (  # noqa: F401
    create_model, get_model, get_model_fn, get_score_fn)
