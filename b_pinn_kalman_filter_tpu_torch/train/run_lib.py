"""Entry points: ``train``, the score model's training loop; ``sample``,
the serving path; ``sample_from_checkpoint``, the ``sample`` mode; and
``evaluate``, the ``eval`` mode.

Counterpart of the JAX package's ``train/run_lib.py``.  ``sample`` takes
its weights as a flax ``params`` tree handed in (the JAX package's own,
through ``models.convert.params_from_jax``), a built model, or the
model's seeded init; ``sample_from_checkpoint`` is the JAX ``sample``,
which restores a checkpoint first.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch.core import likelihood as likelihood_lib
from b_pinn_kalman_filter_tpu_torch.core import losses, sampling
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.data.datasets import get_dataset
from b_pinn_kalman_filter_tpu_torch.data.scalers import (
    get_data_inverse_scaler, get_data_scaler)
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.models import registry as mutils
from b_pinn_kalman_filter_tpu_torch.models.convert import params_from_jax
from b_pinn_kalman_filter_tpu_torch.train import checkpoint as ckpt_lib
from b_pinn_kalman_filter_tpu_torch.train import evaluation
from b_pinn_kalman_filter_tpu_torch.train import state as state_lib
from b_pinn_kalman_filter_tpu_torch.utils.misc import save_image_grid

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
  to ``samples/iter_{s}/sample.np`` (uint8) and ``sample.png`` (their
  grid), as the JAX loop saves both.  Losses go to this module's logger
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
        save_image_grid(sample, os.path.join(this_sample_dir, 'sample.png'))

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


def _template(config, device, seed: int
              ) -> Tuple[state_lib.TrainState, torch.nn.Module]:
  """(a train state of the config's model, its seeded init, to restore
  into; the model)."""
  model = mutils.create_model(config, device=device, seed=seed)
  return state_lib.create_train_state(dict(model.named_parameters()),
                                      losses.get_optimizer(config),
                                      config.model.ema_rate), model


def sample_from_checkpoint(config, ckptdir: str, workdir: str, *,
                           device=None) -> Tuple[torch.Tensor, int]:
  """The ``sample`` mode (JAX ``sample(config, ckptdir, workdir)``): the
  checkpoint at ``ckptdir`` restored into the model's seeded init (left
  as it is, with a warning, where there is none), ``training.batch_size``
  samples under its EMA parameters, seeded with ``config.seed``, and their
  grid written to ``workdir/sample.png``.  Returns ``(samples, nfe)``."""
  device = get_device(device)
  state, model = _template(config, device, config.seed)
  state = ckpt_lib.restore_checkpoint(ckptdir, state)
  sde, sampling_eps = sde_lib.get_sde(config)
  shape = (config.training.batch_size, config.data.image_size,
           config.data.image_size, config.data.num_channels)
  sampling_fn = sampling.get_sampling_fn(
      config, sde, model, shape, get_data_inverse_scaler(config),
      sampling_eps, device=device)
  generator = torch.Generator(device=device).manual_seed(config.seed)
  samples, nfe = sampling_fn(generator=generator, params=state.ema_params)
  os.makedirs(workdir, exist_ok=True)
  save_image_grid(samples.float().cpu().numpy(),
                  os.path.join(workdir, 'sample.png'))
  return samples, nfe


def _wait_and_restore(ckpt_path: str, template: state_lib.TrainState,
                      wait: bool, poll_seconds: float = 60.0,
                      retries: int = 3) -> Optional[state_lib.TrainState]:
  """The checkpoint at ``ckpt_path`` restored into ``template``; with
  ``wait``, polled for every ``poll_seconds`` until it appears, else None
  where it is absent.  A read that fails (a checkpoint half written by a
  trainer alongside) is retried ``retries`` times, after ``poll_seconds``
  times the attempt (2 s times it without ``wait``)."""
  while not os.path.exists(ckpt_path):
    if not wait:
      return None
    logger.warning('Waiting for checkpoint at %s ...', ckpt_path)
    time.sleep(poll_seconds)
  for attempt in range(retries + 1):
    try:
      return ckpt_lib.restore_checkpoint(ckpt_path, template)
    except (OSError, RuntimeError, EOFError, KeyError, ValueError) as exc:
      if attempt == retries:
        raise
      backoff = poll_seconds * (attempt + 1) if wait else 2.0 * (attempt + 1)
      logger.warning('Failed to read %s (%s); retrying in %.0fs', ckpt_path,
                     exc, backoff)
      time.sleep(backoff)


@contextlib.contextmanager
def _timed(history, device, **entry):
  """Yields ``entry``, then appends it with the block's synchronised host
  seconds to ``history`` (when it is a list)."""
  start = time.perf_counter()
  yield entry
  if history is not None:
    if device.type == 'cuda':
      torch.cuda.synchronize(device)
    history.append(dict(entry, seconds=time.perf_counter() - start))


def evaluate(config, workdir: str, eval_folder: str = 'eval', *,
             device=None, history: Optional[List[Dict[str, Any]]] = None
             ) -> Dict[str, Any]:
  """The ``eval`` mode (JAX ``evaluate``) over the checkpoints
  ``workdir/checkpoints/checkpoint_{eval.begin_ckpt..eval.end_ckpt}``,
  into ``workdir/eval_folder``; returns the results dict.

  For each checkpoint found (or, with ``eval.wait_for_ckpt``, waited for),
  under its EMA parameters: with ``eval.enable_loss`` the eval loss over
  one epoch of the eval split (``ckpt_{n}_loss.npz``); with
  ``eval.enable_bpd`` bits/dim by the probability-flow ODE
  (``core/likelihood.py``) over that epoch, five times for
  ``bpd_dataset`` 'test' (``{bpd_dataset}_ckpt_{n}_bpd.npz``); with
  ``eval.enable_sampling`` ``num_samples // batch_size + 1`` rounds of
  ``eval.batch_size`` samples (``ckpt_{n}/samples_{r}.npz``, uint8) and
  FID, KID and IS against the eval split's features
  (``report_{n}.npz``, the extractor's label in ``feature_source``).  The
  eval split is ``get_dataset(evaluation=True)``'s one epoch of
  ``eval.batch_size``, the last partial batch dropped.  One
  ``torch.Generator`` seeded with ``config.seed + 1`` feeds the loss's
  draws, the probes and the samples.  With ``history`` a list, each bpd
  batch and sampling round is synchronised and appended as ``{ckpt,
  kind, seconds, nfe}``.
  """
  device = get_device(device)
  eval_dir = os.path.join(workdir, eval_folder)
  os.makedirs(eval_dir, exist_ok=True)
  _, eval_ds = get_dataset(config, evaluation=True)
  scaler = get_data_scaler(config)
  inverse_scaler = get_data_inverse_scaler(config)
  generator = torch.Generator(device=device).manual_seed(config.seed + 1)
  template, model = _template(config, device, config.seed + 1)
  tx = losses.get_optimizer(config)
  sde, sampling_eps = sde_lib.get_sde(config)
  ev = config.eval
  eval_step_fn = losses.get_step_fn(
      sde, model, tx, train=False, reduce_mean=config.training.reduce_mean,
      continuous=config.training.continuous,
      likelihood_weighting=config.training.likelihood_weighting)
  if ev.enable_bpd:
    likelihood_fn = likelihood_lib.get_likelihood_fn(sde, model,
                                                     inverse_scaler)
  if ev.enable_sampling:
    shape = (ev.batch_size, config.data.image_size, config.data.image_size,
             config.data.num_channels)
    sampling_fn = sampling.get_sampling_fn(config, sde, model, shape,
                                           inverse_scaler, sampling_eps,
                                           device=device)
    feature_fn, feature_source = evaluation.get_feature_extractor(
        config, device=device)
    ref_feats = evaluation.load_dataset_stats(
        config, eval_ds, feature_fn, feature_source,
        stats_dir=os.path.join(eval_dir, 'assets'),
        max_images=int(ev.get('num_ref_images', 2048)))
  wait_for_ckpt = bool(ev.get('wait_for_ckpt', False))

  checkpoint_dir = os.path.join(workdir, 'checkpoints')
  results: Dict[str, Any] = {}
  for ckpt in range(ev.begin_ckpt, ev.end_ckpt + 1):
    ckpt_path = os.path.join(checkpoint_dir, f'checkpoint_{ckpt}')
    state = _wait_and_restore(ckpt_path, template, wait_for_ckpt)
    if state is None:
      logger.warning('checkpoint_%d not found; skipping', ckpt)
      continue

    if ev.enable_loss:
      all_losses = []
      for item in iter(eval_ds):
        batch = _next_batch(iter([item]), scaler, device)
        _, eval_loss = eval_step_fn(state, batch, generator)
        all_losses.append(float(eval_loss))
      all_losses = np.asarray(all_losses)
      np.savez_compressed(os.path.join(eval_dir, f'ckpt_{ckpt}_loss.npz'),
                          all_losses=all_losses, mean_loss=all_losses.mean())
      results[f'ckpt_{ckpt}_loss'] = float(all_losses.mean())

    if ev.enable_bpd:
      bpds = []
      repeats = 5 if ev.bpd_dataset.lower() == 'test' else 1
      for repeat in range(repeats):
        for batch_id, item in enumerate(iter(eval_ds)):
          batch = _next_batch(iter([item]), scaler, device)
          with _timed(history, device, ckpt=ckpt, kind='bpd') as entry:
            bpd, _, nfe = likelihood_fn(state.ema_params, batch, generator)
            entry['nfe'] = nfe
          bpds.extend(bpd.cpu().numpy().reshape(-1))
          logger.info('ckpt: %d, repeat: %d, batch: %d, mean bpd: %6f',
                      ckpt, repeat, batch_id, np.mean(bpds))
      np.savez_compressed(
          os.path.join(eval_dir, f'{ev.bpd_dataset}_ckpt_{ckpt}_bpd.npz'),
          bpd=np.asarray(bpds))
      results[f'ckpt_{ckpt}_bpd'] = float(np.mean(bpds))

    if ev.enable_sampling:
      num_rounds = ev.num_samples // ev.batch_size + 1
      this_sample_dir = os.path.join(eval_dir, f'ckpt_{ckpt}')
      os.makedirs(this_sample_dir, exist_ok=True)
      sample_pools, sample_logits = [], []
      for r in range(num_rounds):
        with _timed(history, device, ckpt=ckpt, kind='sample') as entry:
          samples, entry['nfe'] = sampling_fn(generator=generator,
                                              params=state.ema_params)
        samples01 = np.clip(samples.float().cpu().numpy(), 0., 1.)
        np.savez_compressed(
            os.path.join(this_sample_dir, f'samples_{r}.npz'),
            samples=(samples01 * 255.).astype(np.uint8))
        pool, logit = feature_fn(samples01)
        sample_pools.append(pool)
        sample_logits.append(logit)
        logger.info('sampling -- ckpt: %d, round: %d', ckpt, r)
      sample_pools = np.concatenate(sample_pools)
      metrics = {
          'fid': evaluation.frechet_distance(sample_pools, ref_feats),
          'kid': evaluation.kernel_distance(sample_pools, ref_feats),
          'inception_score': evaluation.inception_score(
              np.concatenate(sample_logits)),
      }
      logger.info('ckpt-%d --- FID: %.6e, KID: %.6e, Inception score: %.6e '
                  '(features: %s)', ckpt, metrics['fid'], metrics['kid'],
                  metrics['inception_score'], feature_source)
      np.savez_compressed(
          os.path.join(eval_dir, f'report_{ckpt}.npz'), fid=metrics['fid'],
          kid=metrics['kid'], IS=metrics['inception_score'],
          feature_source=feature_source)
      for k, v in metrics.items():
        results[f'ckpt_{ckpt}_{k}'] = float(v)
      results['feature_source'] = feature_source
  return results
