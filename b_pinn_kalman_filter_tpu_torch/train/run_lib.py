"""Entry points: ``train``, the score model's training loop, and
``sample``, the serving path.

Counterpart of the JAX package's ``train/run_lib.py`` ``train`` and
``sample``.  ``sample`` has no checkpoints: its weights are a flax
``params`` tree handed in (the JAX package's own, through
``models.convert.params_from_jax``) or the model's seeded init.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch.core import losses, sampling
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.data.datasets import get_dataset
from b_pinn_kalman_filter_tpu_torch.data.scalers import (
    get_data_inverse_scaler, get_data_scaler)
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.models import registry as mutils
from b_pinn_kalman_filter_tpu_torch.models.convert import params_from_jax
from b_pinn_kalman_filter_tpu_torch.train import checkpoint as ckpt_lib
from b_pinn_kalman_filter_tpu_torch.train import state as state_lib

logger = logging.getLogger(__name__)


def train(config, workdir: str, *, device=None,
          history: Optional[List[Dict[str, Any]]] = None
          ) -> state_lib.TrainState:
  """Train the score model of ``config`` on ``device`` (default ``cuda``)
  for ``training.n_iters`` steps; returns the final train state.

  The JAX ``train`` loop, step for step: the model's seeded init, Adam
  with warmup and clipping, the EMA; the preemption checkpoint
  ``workdir/checkpoints-meta/checkpoint`` restored at start when present;
  then at each step ``s`` from the restored one to ``n_iters``, after the
  update: the loss logged (``s % log_freq == 0``), the preemption
  checkpoint saved (``s != 0`` and ``s % snapshot_freq_for_preemption ==
  0``), an eval loss under the EMA on an eval batch (``s % eval_freq ==
  0``), and a snapshot (``s != 0`` and ``s % snapshot_freq == 0`` or ``s
  == n_iters``): ``checkpoints/checkpoint_{s // snapshot_freq}`` and, with
  ``snapshot_sampling``, ``batch_size // 4`` samples under the EMA saved
  to ``samples/iter_{s}/sample.np`` (uint8; the PNG grid waits for the
  ``utils`` port, ROADMAP.md A.7).  Losses go to this module's logger
  (no TensorBoard writer).  One ``torch.Generator`` seeded with
  ``config.seed`` feeds t, z, dropout, the eval draws and the samples.
  ``tpu.steps_per_dispatch`` is kept for its key and changes nothing: the
  port steps one at a time.

  With ``history`` a list, each step is synchronised and appended as
  ``{step, seconds, loss, events}``: host seconds from fetching its batch
  to the end of its events, and the events that fired.
  """
  device = get_device(device)
  sample_dir = os.path.join(workdir, 'samples')
  checkpoint_dir = os.path.join(workdir, 'checkpoints')
  checkpoint_meta = os.path.join(workdir, 'checkpoints-meta', 'checkpoint')
  for d in (sample_dir, checkpoint_dir, os.path.dirname(checkpoint_meta)):
    os.makedirs(d, exist_ok=True)

  model = mutils.create_model(config, device=device, seed=config.seed)
  tx = losses.get_optimizer(config)
  state = state_lib.create_train_state(dict(model.named_parameters()), tx,
                                       config.model.ema_rate)
  state = ckpt_lib.restore_checkpoint(checkpoint_meta, state, quiet=True)
  initial_step = state.step

  train_ds, eval_ds = get_dataset(config)
  train_iter, eval_iter = iter(train_ds), iter(eval_ds)
  scaler = get_data_scaler(config)
  inverse_scaler = get_data_inverse_scaler(config)
  sde, sampling_eps = sde_lib.get_sde(config)

  common = dict(reduce_mean=config.training.reduce_mean,
                continuous=config.training.continuous,
                likelihood_weighting=config.training.likelihood_weighting)
  train_step_fn = losses.get_step_fn(sde, model, tx, train=True, **common)
  eval_step_fn = losses.get_step_fn(sde, model, tx, train=False, **common)
  if config.training.snapshot_sampling:
    sampling_shape = (config.training.batch_size // 4,
                      config.data.image_size, config.data.image_size,
                      config.data.num_channels)
    sampling_fn = sampling.get_sampling_fn(
        config, sde, model, sampling_shape, inverse_scaler, sampling_eps,
        device=device)
  generator = torch.Generator(device=device).manual_seed(config.seed)

  t = config.training
  num_train_steps = t.n_iters
  events = {
      'log': lambda s: s % t.log_freq == 0,
      'preempt_ckpt':
          lambda s: s != 0 and s % t.snapshot_freq_for_preemption == 0,
      'eval': lambda s: s % t.eval_freq == 0,
      'snapshot':
          lambda s: s != 0 and (s % t.snapshot_freq == 0
                                or s == num_train_steps),
  }
  logger.info('Starting training loop at step %d.', initial_step)
  step = initial_step
  while step <= num_train_steps:
    start = time.perf_counter()
    batch = _next_batch(train_iter, scaler, device)
    state, loss = train_step_fn(state, batch, generator)
    fired = [name for name, due in events.items() if due(step)]

    if 'log' in fired:
      logger.info('step: %d, training_loss: %.5e', step, float(loss))
    if 'preempt_ckpt' in fired:
      ckpt_lib.save_checkpoint(checkpoint_meta, state)
    if 'eval' in fired:
      eval_batch = _next_batch(eval_iter, scaler, device)
      _, eval_loss = eval_step_fn(state, eval_batch, generator)
      logger.info('step: %d, eval_loss: %.5e', step, float(eval_loss))
    if 'snapshot' in fired:
      save_step = step // t.snapshot_freq
      ckpt_lib.save_checkpoint(
          os.path.join(checkpoint_dir, f'checkpoint_{save_step}'), state)
      logger.info('checkpoint_%d saved', save_step)
      if t.snapshot_sampling:
        sample, _ = sampling_fn(generator=generator, params=state.ema_params)
        this_sample_dir = os.path.join(sample_dir, f'iter_{step}')
        os.makedirs(this_sample_dir, exist_ok=True)
        sample = sample.float().cpu().numpy()
        with open(os.path.join(this_sample_dir, 'sample.np'), 'wb') as f:
          np.save(f, np.clip(sample * 255, 0, 255).astype(np.uint8))

    if history is not None:
      if device.type == 'cuda':
        torch.cuda.synchronize(device)
      history.append(dict(step=step, seconds=time.perf_counter() - start,
                          loss=float(loss), events=fired))
    step += 1
  return state


def _next_batch(it, scaler, device) -> torch.Tensor:
  item = next(it)
  batch = item[0] if isinstance(item, tuple) else item
  return torch.from_numpy(scaler(np.asarray(batch, np.float32))).to(device)


def sample(config, params: Optional[Mapping[str, Any]] = None, *,
           batch_size: Optional[int] = None, seed: Optional[int] = None,
           device=None, model: Optional[torch.nn.Module] = None
           ) -> Tuple[torch.Tensor, int]:
  """Draw ``batch_size`` samples (NHWC, inverse-scaled) on ``device``.

  ``batch_size`` defaults to ``config.training.batch_size`` and ``seed`` to
  ``config.seed``; the seed drives both the model's init (when neither
  ``params`` nor ``model`` is given) and the sampler's noise.  ``model``
  lets a server build the network once and reuse it across requests.
  Returns ``(samples, nfe)``.
  """
  device = get_device(device)
  seed = config.seed if seed is None else seed
  batch_size = config.training.batch_size if batch_size is None else batch_size
  if model is None:
    model = mutils.create_model(config, device=device, seed=seed)
    if params is not None:
      params_from_jax(params, model)
  elif params is not None:
    raise ValueError('pass params or model, not both')

  sde, sampling_eps = sde_lib.get_sde(config)
  shape = (batch_size, config.data.image_size, config.data.image_size,
           config.data.num_channels)
  sampling_fn = sampling.get_sampling_fn(
      config, sde, model, shape, get_data_inverse_scaler(config),
      sampling_eps, device=device)
  generator = torch.Generator(device=device).manual_seed(seed)
  return sampling_fn(generator=generator)
