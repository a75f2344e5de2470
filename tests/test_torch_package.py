"""The port stands alone: it and chip_smoke.py import nothing of JAX or of
the JAX package, entry points default to the card, and the port's configs
carry the JAX configs' keys."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import b_pinn_kalman_filter_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):
  importlib.import_module(mod.name)
import chip_smoke  # module-level code only: main() runs under __main__
banned = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ml_collections',
          'b_pinn_kalman_filter_tpu', 'triton')
bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)
assert not bad, bad
import torch
if not torch.cuda.is_available():
  sys.argv = ['chip_smoke.py']
  assert chip_smoke.main() == 2     # no card: no result, non-zero exit
  from b_pinn_kalman_filter_tpu_torch.device import get_device
  from b_pinn_kalman_filter_tpu_torch.train import run_lib
  from b_pinn_kalman_filter_tpu_torch.kalman import ukf_lib
  from b_pinn_kalman_filter_tpu_torch import configs
  for call in (get_device,
               lambda: run_lib.sample(configs.get_config(
                   'vp/cifar10_ddpmpp_continuous'), batch_size=1),
               lambda: ukf_lib.run(configs.get_config('pinn/pinn_pde'),
                                   'workdir-never-made', n_steps=1)):
    try:
      call()
    except RuntimeError as e:
      assert 'CUDA is not available' in str(e), e
    else:
      raise AssertionError('the default device did not raise')
print('ok')
"""


def test_port_imports_no_jax_and_defaults_to_the_card():
  """In a fresh interpreter: import every port module and chip_smoke.py,
  then check sys.modules, and without a card that the default device,
  run_lib.sample, ukf_lib.run and chip_smoke.main() refuse."""
  env = dict(os.environ, PYTHONPATH=ROOT)
  out = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=240)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip().endswith('ok')


def _keys(tree, prefix=''):
  out = {}
  for key, value in tree.items():
    if hasattr(value, 'items'):
      out.update(_keys(value, f'{prefix}{key}.'))
    else:
      out[f'{prefix}{key}'] = value
  return out


def test_config_has_the_jax_keys_and_values():
  _check_config_keys('vp/cifar10_ddpmpp_continuous')


def test_pinn_config_has_the_jax_keys_and_values():
  _check_config_keys('pinn/pinn_pde')


def _check_config_keys(name):
  from b_pinn_kalman_filter_tpu import configs as jax_configs
  from b_pinn_kalman_filter_tpu_torch import configs as torch_configs
  want = _keys(jax_configs.get_config(name))
  got = _keys(torch_configs.get_config(name))
  # Dropped on purpose: on CUDA the kernels always run.
  for key in ('tpu.winograd', 'tpu.fused_groupnorm'):
    del want[key]
  assert got.pop('device') == 'cuda' and want.pop('device') == 'tpu'
  assert got == want


def test_config_dict_attribute_access():
  from b_pinn_kalman_filter_tpu_torch.configs.config_dict import ConfigDict
  c = ConfigDict()
  c.model = ConfigDict()
  c.model.nf = 128
  assert c['model']['nf'] == 128 and 'model' in c
  assert c == {'model': {'nf': 128}}
  with pytest.raises(AttributeError):
    _ = c.missing
