"""Controllable generation: PC inpainting and colorization.

Counterpart of the JAX package's ``core/controllable.py``: the PC loop of
``core/sampling.py`` with the known part of the image re-imposed, noised to
each step's time, after every corrector and predictor update.  The noise
comes from a ``torch.Generator``, or from ``noise``, an iterable whose
first tensor is the prior sample and whose next are the standard normals
in the order they are drawn: each step's corrector draws, its data noise,
the predictor's draws and its data noise.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch.core import ode as ode_lib
from b_pinn_kalman_filter_tpu_torch.core.sde import batch_mul
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.models import registry as mutils


def _draws(sde, shape, generator, noise, device):
  """(the prior sample, ``draw()``: the next standard normal of
  ``shape``)."""
  if noise is None:
    return (sde.prior_sampling(shape, generator=generator, device=device),
            lambda: torch.randn(shape, generator=generator, device=device))
  stream = iter(noise)
  return next(stream).to(device), lambda: next(stream).to(device)


def _pc_loop(sde, model, predictor, corrector, snr, n_steps,
             probability_flow, continuous, eps, x, known, update, draw,
             params):
  """The PC steps from ``x``; ``update(x, x_mean, vec_t)`` re-imposes the
  known part after each corrector and predictor update.  Returns the last
  (x, x_mean)."""
  score_fn = mutils.get_score_fn(sde, model, train=False,
                                 continuous=continuous, params=params)
  x_mean = x
  for t in ode_lib.linspace(sde.T, eps, sde.N):
    vec_t = torch.full((known.shape[0],), float(t), device=known.device)
    x, x_mean = corrector(x, vec_t, sde, score_fn, snr, n_steps, draw)
    x, x_mean = update(x, x_mean, vec_t)
    x, x_mean = predictor(x, vec_t, sde, score_fn, probability_flow, draw)
    x, x_mean = update(x, x_mean, vec_t)
  return x, x_mean


def get_pc_inpainter(sde, model, predictor, corrector, inverse_scaler, snr,
                     n_steps=1, probability_flow=False, continuous=False,
                     denoise=True, eps=1e-5, device=None):
  """PC inpainter: ``fn(data, mask, generator=None, noise=None,
  params=None)``, mask 1 on the known pixels."""
  device = get_device(device)

  def pc_inpainter(data, mask, generator: Optional[torch.Generator] = None,
                   noise: Optional[Iterable[torch.Tensor]] = None,
                   params: Optional[Dict[str, torch.Tensor]] = None):
    with torch.inference_mode():
      data, mask = data.to(device), mask.to(device)
      prior, draw = _draws(sde, data.shape, generator, noise, device)

      def update(x, x_mean, vec_t):
        masked_data_mean, std = sde.marginal_prob(data, vec_t)
        masked_data = masked_data_mean + batch_mul(std, draw())
        x = x * (1. - mask) + masked_data * mask
        # As in the reference: the mean from the updated x.
        return x, x * (1. - mask) + masked_data_mean * mask

      x = data * mask + prior * (1. - mask)
      x, x_mean = _pc_loop(sde, model, predictor, corrector, snr, n_steps,
                           probability_flow, continuous, eps, x, data,
                           update, draw, params)
      return inverse_scaler(x_mean if denoise else x)

  return pc_inpainter


# Orthonormal decoupling matrix: gray scale occupies one latent channel.
_M = np.array([[5.7735014e-01, -8.1649649e-01, 4.7008697e-08],
               [5.7735026e-01, 4.0824834e-01, 7.0710671e-01],
               [5.7735026e-01, 4.0824822e-01, -7.0710683e-01]], np.float32)
_invM = np.linalg.inv(_M)


def decouple(inputs):
  m = torch.as_tensor(_M, device=inputs.device)
  return torch.einsum('bhwi,ij->bhwj', inputs, m)


def couple(inputs):
  m = torch.as_tensor(_invM, device=inputs.device)
  return torch.einsum('bhwi,ij->bhwj', inputs, m)


def get_pc_colorizer(sde, model, predictor, corrector, inverse_scaler, snr,
                     n_steps=1, probability_flow=False, continuous=False,
                     denoise=True, eps=1e-5, device=None):
  """PC colorizer: ``fn(gray_scale_img, generator=None, noise=None,
  params=None)`` for a three-channel gray image."""
  device = get_device(device)

  def get_mask(image):
    return torch.cat([torch.ones_like(image[..., :1]),
                      torch.zeros_like(image[..., 1:])], dim=-1)

  def pc_colorizer(gray_scale_img,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Iterable[torch.Tensor]] = None,
                   params: Optional[Dict[str, torch.Tensor]] = None):
    with torch.inference_mode():
      gray = gray_scale_img.to(device)
      mask = get_mask(gray)
      prior, draw = _draws(sde, gray.shape, generator, noise, device)

      def update(x, x_mean, vec_t):
        masked_data_mean, std = sde.marginal_prob(decouple(gray), vec_t)
        masked_data = masked_data_mean + batch_mul(std, draw())
        x = couple(decouple(x) * (1. - mask) + masked_data * mask)
        return x, couple(decouple(x) * (1. - mask)
                         + masked_data_mean * mask)

      x = couple(decouple(gray) * mask + decouple(prior * (1. - mask)))
      x, x_mean = _pc_loop(sde, model, predictor, corrector, snr, n_steps,
                           probability_flow, continuous, eps, x, gray,
                           update, draw, params)
      return inverse_scaler(x_mean if denoise else x)

  return pc_colorizer
