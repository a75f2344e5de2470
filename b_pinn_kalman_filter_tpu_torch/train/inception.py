"""InceptionV3 feature extractor for FID/KID/IS.

Counterpart of the JAX package's ``train/inception.py``: the torchvision
``Inception3`` topology (Conv2d_1a .. Mixed_7c and fc) over a flat
``{name: (HWIO kernel, bias)}`` dict of numpy arrays, BatchNorms folded
into the convs at load (:func:`_fold_bn`), so each layer is conv + bias +
ReLU.  The forward resizes to 299^2 (bilinear, half-pixel centres, no
antialias, as ``jax.image.resize``), maps [0, 1] to [-1, 1], and averages
in its in-block pools over the unpadded window (``count_include_pad=
False``, the TF/FID convention the JAX forward and
tests/torch_inception_oracle.py document).  Features are the 2048-d global
mean pool, logits the 1000-way fc.  Names keep the JAX package's (NHWC at
the public functions; NCHW inside, for ``F.conv2d``).

Weights: ``load_inception_params`` reads a converted ``.npz`` or a
torchvision ``inception_v3`` state_dict ``.pth`` only where one is on disk
(``$BPKF_INCEPTION_WEIGHTS`` or ``<data dir>/inception_v3.{npz,pth}``);
``random_inception_params`` draws He-scaled weights from a
``torch.Generator`` for the labelled random-weights proxy.  These are
cuDNN convolutions on the card: the JAX forward is XLA's, not a Pallas
kernel.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.data.datasets import data_dir
from b_pinn_kalman_filter_tpu_torch.device import get_device

Params = Dict[str, Tuple[np.ndarray, np.ndarray]]

_P0 = ((0, 0), (0, 0))


def _spec():
  """(name, (kh, kw), cin, cout, stride, ((top, bottom), (left, right)))
  of every conv, in forward order."""
  s = []

  def c(name, k, cin, cout, stride=1, pad=_P0):
    s.append((name, k, cin, cout, stride, pad))

  c('Conv2d_1a_3x3', (3, 3), 3, 32, 2)
  c('Conv2d_2a_3x3', (3, 3), 32, 32)
  c('Conv2d_2b_3x3', (3, 3), 32, 64, 1, ((1, 1), (1, 1)))
  c('Conv2d_3b_1x1', (1, 1), 64, 80)
  c('Conv2d_4a_3x3', (3, 3), 80, 192)

  def inception_a(prefix, cin, pool_features):
    c(f'{prefix}.branch1x1', (1, 1), cin, 64)
    c(f'{prefix}.branch5x5_1', (1, 1), cin, 48)
    c(f'{prefix}.branch5x5_2', (5, 5), 48, 64, 1, ((2, 2), (2, 2)))
    c(f'{prefix}.branch3x3dbl_1', (1, 1), cin, 64)
    c(f'{prefix}.branch3x3dbl_2', (3, 3), 64, 96, 1, ((1, 1), (1, 1)))
    c(f'{prefix}.branch3x3dbl_3', (3, 3), 96, 96, 1, ((1, 1), (1, 1)))
    c(f'{prefix}.branch_pool', (1, 1), cin, pool_features)

  def inception_b(prefix, cin):
    c(f'{prefix}.branch3x3', (3, 3), cin, 384, 2)
    c(f'{prefix}.branch3x3dbl_1', (1, 1), cin, 64)
    c(f'{prefix}.branch3x3dbl_2', (3, 3), 64, 96, 1, ((1, 1), (1, 1)))
    c(f'{prefix}.branch3x3dbl_3', (3, 3), 96, 96, 2)

  def inception_c(prefix, cin, c7):
    c(f'{prefix}.branch1x1', (1, 1), cin, 192)
    c(f'{prefix}.branch7x7_1', (1, 1), cin, c7)
    c(f'{prefix}.branch7x7_2', (1, 7), c7, c7, 1, ((0, 0), (3, 3)))
    c(f'{prefix}.branch7x7_3', (7, 1), c7, 192, 1, ((3, 3), (0, 0)))
    c(f'{prefix}.branch7x7dbl_1', (1, 1), cin, c7)
    c(f'{prefix}.branch7x7dbl_2', (7, 1), c7, c7, 1, ((3, 3), (0, 0)))
    c(f'{prefix}.branch7x7dbl_3', (1, 7), c7, c7, 1, ((0, 0), (3, 3)))
    c(f'{prefix}.branch7x7dbl_4', (7, 1), c7, c7, 1, ((3, 3), (0, 0)))
    c(f'{prefix}.branch7x7dbl_5', (1, 7), c7, 192, 1, ((0, 0), (3, 3)))
    c(f'{prefix}.branch_pool', (1, 1), cin, 192)

  def inception_d(prefix, cin):
    c(f'{prefix}.branch3x3_1', (1, 1), cin, 192)
    c(f'{prefix}.branch3x3_2', (3, 3), 192, 320, 2)
    c(f'{prefix}.branch7x7x3_1', (1, 1), cin, 192)
    c(f'{prefix}.branch7x7x3_2', (1, 7), 192, 192, 1, ((0, 0), (3, 3)))
    c(f'{prefix}.branch7x7x3_3', (7, 1), 192, 192, 1, ((3, 3), (0, 0)))
    c(f'{prefix}.branch7x7x3_4', (3, 3), 192, 192, 2)

  def inception_e(prefix, cin):
    c(f'{prefix}.branch1x1', (1, 1), cin, 320)
    c(f'{prefix}.branch3x3_1', (1, 1), cin, 384)
    c(f'{prefix}.branch3x3_2a', (1, 3), 384, 384, 1, ((0, 0), (1, 1)))
    c(f'{prefix}.branch3x3_2b', (3, 1), 384, 384, 1, ((1, 1), (0, 0)))
    c(f'{prefix}.branch3x3dbl_1', (1, 1), cin, 448)
    c(f'{prefix}.branch3x3dbl_2', (3, 3), 448, 384, 1, ((1, 1), (1, 1)))
    c(f'{prefix}.branch3x3dbl_3a', (1, 3), 384, 384, 1, ((0, 0), (1, 1)))
    c(f'{prefix}.branch3x3dbl_3b', (3, 1), 384, 384, 1, ((1, 1), (0, 0)))
    c(f'{prefix}.branch_pool', (1, 1), cin, 192)

  inception_a('Mixed_5b', 192, 32)
  inception_a('Mixed_5c', 256, 64)
  inception_a('Mixed_5d', 288, 64)
  inception_b('Mixed_6a', 288)
  inception_c('Mixed_6b', 768, 128)
  inception_c('Mixed_6c', 768, 160)
  inception_c('Mixed_6d', 768, 160)
  inception_c('Mixed_6e', 768, 192)
  inception_d('Mixed_7a', 768)
  inception_e('Mixed_7b', 1280)
  inception_e('Mixed_7c', 2048)
  return s


CONV_SPEC = _spec()
_SPEC_BY_NAME = {name: (k, cin, cout, stride, pad)
                 for name, k, cin, cout, stride, pad in CONV_SPEC}
NUM_LOGITS = 1000
FEATURE_DIM = 2048


def random_inception_params(generator: torch.Generator) -> Params:
  """Parameters of the right shapes from ``generator``: He-scaled kernels
  (sqrt(2 / fan_in): with 1 / sqrt(fan_in) the ReLU stack halves the
  variance at each layer and the features vanish), zero biases, the fc
  over sqrt(2048)."""
  params = {}
  for name, k, cin, cout, _, _ in CONV_SPEC:
    w = torch.randn(k + (cin, cout), generator=generator, dtype=torch.float64)
    params[name] = ((w * np.sqrt(2.0 / (k[0] * k[1] * cin))).float().numpy(),
                    np.zeros(cout, np.float32))
  wfc = torch.randn((FEATURE_DIM, NUM_LOGITS), generator=generator,
                    dtype=torch.float64)
  params['fc'] = ((wfc / np.sqrt(FEATURE_DIM)).float().numpy(),
                  np.zeros(NUM_LOGITS, np.float32))
  return params


def _maxpool3s2(x):
  return F.max_pool2d(x, 3, 2)


def _avgpool3s1p1(x):
  return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class _Net:
  """The forward over parameters moved to a device once (OIHW kernels)."""

  def __init__(self, params: Params, device):
    self.convs = {}
    for name, (k, _, _, stride, pad) in _SPEC_BY_NAME.items():
      w, b = params[name]
      self.convs[name] = (
          torch.tensor(np.asarray(w, np.float32), device=device)
          .permute(3, 2, 0, 1).contiguous(),
          torch.tensor(np.asarray(b, np.float32), device=device),
          stride, (pad[0][0], pad[1][0]))
    wfc, bfc = params['fc']
    self.fc = (torch.tensor(np.asarray(wfc, np.float32), device=device),
               torch.tensor(np.asarray(bfc, np.float32), device=device))

  def conv(self, name, x):
    w, b, stride, padding = self.convs[name]
    return F.relu(F.conv2d(x, w, b, stride=stride, padding=padding))

  def chain(self, x, *names):
    for name in names:
      x = self.conv(name, x)
    return x

  def block_a(self, p, x):
    return torch.cat([
        self.conv(f'{p}.branch1x1', x),
        self.chain(x, f'{p}.branch5x5_1', f'{p}.branch5x5_2'),
        self.chain(x, f'{p}.branch3x3dbl_1', f'{p}.branch3x3dbl_2',
                   f'{p}.branch3x3dbl_3'),
        self.conv(f'{p}.branch_pool', _avgpool3s1p1(x))], dim=1)

  def block_b(self, p, x):
    return torch.cat([
        self.conv(f'{p}.branch3x3', x),
        self.chain(x, f'{p}.branch3x3dbl_1', f'{p}.branch3x3dbl_2',
                   f'{p}.branch3x3dbl_3'),
        _maxpool3s2(x)], dim=1)

  def block_c(self, p, x):
    return torch.cat([
        self.conv(f'{p}.branch1x1', x),
        self.chain(x, *(f'{p}.branch7x7_{i}' for i in (1, 2, 3))),
        self.chain(x, *(f'{p}.branch7x7dbl_{i}' for i in (1, 2, 3, 4, 5))),
        self.conv(f'{p}.branch_pool', _avgpool3s1p1(x))], dim=1)

  def block_d(self, p, x):
    return torch.cat([
        self.chain(x, f'{p}.branch3x3_1', f'{p}.branch3x3_2'),
        self.chain(x, *(f'{p}.branch7x7x3_{i}' for i in (1, 2, 3, 4))),
        _maxpool3s2(x)], dim=1)

  def block_e(self, p, x):
    b3 = self.conv(f'{p}.branch3x3_1', x)
    bd = self.chain(x, f'{p}.branch3x3dbl_1', f'{p}.branch3x3dbl_2')
    return torch.cat([
        self.conv(f'{p}.branch1x1', x),
        self.conv(f'{p}.branch3x3_2a', b3), self.conv(f'{p}.branch3x3_2b', b3),
        self.conv(f'{p}.branch3x3dbl_3a', bd),
        self.conv(f'{p}.branch3x3dbl_3b', bd),
        self.conv(f'{p}.branch_pool', _avgpool3s1p1(x))], dim=1)

  @torch.no_grad()
  def __call__(self, images: torch.Tensor):
    x = images.float()
    if x.shape[-1] == 1:
      x = x.repeat(1, 1, 1, 3)
    x = x.permute(0, 3, 1, 2)
    if x.shape[2] != 299 or x.shape[3] != 299:
      x = F.interpolate(x, size=(299, 299), mode='bilinear',
                        align_corners=False, antialias=False)
    x = x * 2.0 - 1.0
    x = _maxpool3s2(self.chain(x, 'Conv2d_1a_3x3', 'Conv2d_2a_3x3',
                               'Conv2d_2b_3x3'))
    x = _maxpool3s2(self.chain(x, 'Conv2d_3b_1x1', 'Conv2d_4a_3x3'))
    for p in ('Mixed_5b', 'Mixed_5c', 'Mixed_5d'):
      x = self.block_a(p, x)
    x = self.block_b('Mixed_6a', x)
    for p in ('Mixed_6b', 'Mixed_6c', 'Mixed_6d', 'Mixed_6e'):
      x = self.block_c(p, x)
    x = self.block_d('Mixed_7a', x)
    x = self.block_e('Mixed_7b', x)
    x = self.block_e('Mixed_7c', x)
    pool = x.mean(dim=(2, 3))
    wfc, bfc = self.fc
    return pool, pool @ wfc + bfc


def inception_forward(params: Params, images: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(B, H, W, C) images in [0, 1] -> (pool3 (B, 2048), logits (B, 1000)),
  on the images' device; a one-channel image is repeated to three."""
  return _Net(params, images.device)(images)


def make_inception_feature_fn(params: Params, batch: int = 128,
                              device=None):
  """``feature_fn(images) -> (pool (N, 2048), logits (N, 1000))``, numpy,
  computed on ``device`` in chunks of ``batch`` (at 299^2 the first layers
  hold ~23 MB of activations an image), the parameters moved there once."""
  device = get_device(device)
  net = _Net(params, device)

  def feature_fn(images):
    return chunked(net, images, batch, device)

  return feature_fn


def chunked(fwd, images, batch: int, device
            ) -> Tuple[np.ndarray, np.ndarray]:
  """``fwd`` (images -> (pool, logits)) over ``images`` in chunks of
  ``batch`` on ``device``; the results concatenated on the host as numpy
  float32."""
  images = torch.as_tensor(np.asarray(images, np.float32))
  pools, logits = [], []
  for i in range(0, max(len(images), 1), batch):
    p, l = fwd(images[i:i + batch].to(device))
    pools.append(p.float().cpu().numpy())
    logits.append(l.float().cpu().numpy())
  return np.concatenate(pools), np.concatenate(logits)


# ---------------------------------------------------------------------------
# Weight loading (torchvision state_dict .pth or converted .npz)
# ---------------------------------------------------------------------------


def _fold_bn(w_oihw: np.ndarray, gamma, beta, mean, var,
             eps: float = 1e-3) -> Tuple[np.ndarray, np.ndarray]:
  """Fold conv + BN into conv + bias; returns (HWIO kernel, bias)."""
  scale = gamma / np.sqrt(var + eps)
  w = w_oihw * scale[:, None, None, None]
  b = beta - mean * scale
  return w.transpose(2, 3, 1, 0).astype(np.float32), b.astype(np.float32)


def params_from_torch_state_dict(sd) -> Params:
  """A torchvision ``inception_v3`` state_dict, BatchNorms folded."""

  def a(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, 'detach') else t)

  params: Params = {}
  for name, *_ in CONV_SPEC:
    params[name] = _fold_bn(
        a(sd[f'{name}.conv.weight']),
        a(sd[f'{name}.bn.weight']), a(sd[f'{name}.bn.bias']),
        a(sd[f'{name}.bn.running_mean']), a(sd[f'{name}.bn.running_var']))
  params['fc'] = (a(sd['fc.weight']).T.astype(np.float32),
                  a(sd['fc.bias']).astype(np.float32))
  return params


def save_params_npz(params: Params, path: str) -> None:
  flat = {}
  for name, (w, b) in params.items():
    flat[f'{name}/w'] = w
    flat[f'{name}/b'] = b
  np.savez_compressed(path, **flat)


def load_params_npz(path: str) -> Params:
  data = np.load(path)
  names = sorted({k.rsplit('/', 1)[0] for k in data.files})
  return {n: (data[f'{n}/w'], data[f'{n}/b']) for n in names}


def load_inception_params(path: Optional[str] = None) -> Optional[Params]:
  """InceptionV3 parameters from disk, or None where no file is there.

  Tried in order: ``path``, ``$BPKF_INCEPTION_WEIGHTS``, then
  ``<data dir>/inception_v3.npz`` and ``.pth``; a ``.pth`` that does not
  load as a state_dict is passed over.
  """
  candidates = [c for c in (path, os.environ.get('BPKF_INCEPTION_WEIGHTS'))
                if c]
  candidates += [os.path.join(data_dir(), 'inception_v3.npz'),
                 os.path.join(data_dir(), 'inception_v3.pth')]
  for cand in candidates:
    if not os.path.exists(cand):
      continue
    if cand.endswith('.npz'):
      return load_params_npz(cand)
    try:
      sd = torch.load(cand, map_location='cpu', weights_only=True)
    except (OSError, RuntimeError, ValueError):
      continue
    if hasattr(sd, 'state_dict'):
      sd = sd.state_dict()
    try:
      return params_from_torch_state_dict(sd)
    except (KeyError, TypeError):
      continue
  return None
