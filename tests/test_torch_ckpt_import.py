"""The port's importer of the reference's ``.pth`` checkpoints
(``models/torch_port.py``, ``scripts/import_torch_checkpoint.py``).

The hand-written NCHW torch oracles (``tests/torch_*_oracle.py``), whose
state-dict keys are the reference's, are converted by the port and must
give the oracle's forward on the CPU, at the tolerances of the JAX
package's importer tests (rtol 1e-4 / atol 1e-5; 1e-3 / 1e-4 where a
division by a small sigma or a deep cascade amplifies the shared f32
noise).  The port's converted dict is also held, leaf for leaf and bit for
bit, against the JAX package's converter (numpy, no JAX program) carried
into the port's names by ``convert.params_from_jax``.  Then the whole
checkpoint: the EMA shadows (the Fourier ``W`` left out), the
DataParallel prefix, the step, a fresh optimizer state, the refusals, and
the import tool's workdir read by the CLI's ``--mode sample`` and by the
B-PINN's MOPED bootstrap.  Port-only apart from the converter tree check;
on one torch thread."""

import os

import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu_torch import __main__ as cli
from b_pinn_kalman_filter_tpu_torch.models import convert, registry
from b_pinn_kalman_filter_tpu_torch.models import torch_port
from b_pinn_kalman_filter_tpu_torch.pinn import bayes
from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
from b_pinn_kalman_filter_tpu_torch.pinn.pinn import PINN
from b_pinn_kalman_filter_tpu_torch.scripts import import_torch_checkpoint
from b_pinn_kalman_filter_tpu_torch.train import checkpoint as ckpt_lib
from b_pinn_kalman_filter_tpu_torch.train.state import (AdamState,
                                                        create_train_state)
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401
from tests.torch_ddpm_oracle import TorchDDPM
from tests.torch_ncsnpp_oracle import TorchNCSNpp
from tests.torch_ncsnv2_oracle import TorchNCSN, TorchNCSNv2
from tests.torch_pinn_oracle import TorchPINN

MLP_SHAPE = (1, 3, 3, 1)


class TorchMLP(torch.nn.Module):
  """The reference MLP's keys (``nn.fc{i}``, reference models/ddpm.py:
  187-202) on NCHW images flattened in CHW order."""

  def __init__(self, config):
    super().__init__()
    self.c, self.size = config.data.num_channels, config.data.image_size
    L = self.c * self.size ** 2
    self.nn = torch.nn.Sequential()
    for i in range(len(MLP_SHAPE) - 1):
      self.nn.add_module(f'fc{i}', torch.nn.Linear(L * MLP_SHAPE[i],
                                                   L * MLP_SHAPE[i + 1]))

  def forward(self, x, labels=None):
    h = x.reshape(x.shape[0], -1)
    for i, m in enumerate(self.nn):
      h = m(h)
      if i != len(self.nn) - 1:
        h = torch.relu(h)
    return h.reshape(-1, self.c, self.size, self.size)


def _configs(family):
  """(JAX config, port config) of a family at the size of the JAX
  importer's tests."""
  if family in ('ddpm', 'ddpm_sigma', 'mlp'):
    pair = port_parity.tiny_configs()
    for config in pair:
      config.data.centered = True
      if family == 'ddpm_sigma':
        config.model.scale_by_sigma = True
      if family == 'mlp':
        config.model.name = 'mlp'
        config.data.num_channels = 1
    return pair
  if family.startswith('ncsnpp_'):
    return port_parity.tiny_ncsnpp_configs(family[len('ncsnpp_'):])
  if family.startswith('ncsn'):
    name, size, nf = {'ncsnv2_64': ('ncsnv2_64', 16, 8),
                      'ncsnv2_64_28': ('ncsnv2_64', 28, 4),
                      'ncsnv2_128': ('ncsnv2_128', 96, 4),
                      'ncsnv2_256': ('ncsnv2_256', 160, 4),
                      'ncsn': ('ncsn', 16, 8),
                      'ncsn_28': ('ncsn', 28, 4)}[family]
    pair = port_parity.tiny_ncsn_configs(name, size)
    for config in pair:
      config.model.nf = nf
    return pair
  return port_parity.tiny_pinn_configs()


def _oracle(family, config, seed):
  torch.manual_seed(seed)
  m = config.model
  sigmas = None if family == 'pinn' else registry.get_sigmas(config)
  if family in ('ddpm', 'ddpm_sigma'):
    oracle = TorchDDPM(
        nf=m.nf, ch_mult=tuple(m.ch_mult), num_res_blocks=m.num_res_blocks,
        attn_resolutions=tuple(m.attn_resolutions),
        image_size=config.data.image_size,
        channels=config.data.num_channels,
        resamp_with_conv=m.resamp_with_conv, dropout=m.dropout,
        centered=config.data.centered, scale_by_sigma=m.scale_by_sigma,
        sigmas=sigmas)
  elif family == 'mlp':
    oracle = TorchMLP(config)
  elif family.startswith('ncsnpp_'):
    oracle = TorchNCSNpp(config, sigmas)
  elif family.startswith('ncsnv2'):
    oracle = TorchNCSNv2(config, sigmas)
  elif family.startswith('ncsn'):
    oracle = TorchNCSN(config)
  else:
    oracle = TorchPINN(config)
  return oracle.eval()


def _convert(family, config, sd):
  if family == 'pinn':
    return torch_port.pinn_params_from_torch_state_dict(sd, config)
  if family == 'mlp':
    return torch_port.mlp_params_from_torch_state_dict(sd, config, MLP_SHAPE)
  return torch_port.convert_reference_checkpoint(
      {'model': sd}, config).params


def _port_model(family, config):
  """The port's model of ``config`` (its own init, to be overwritten)."""
  if family == 'pinn':
    return PINN(config).eval()
  if family == 'mlp':
    from b_pinn_kalman_filter_tpu_torch.models.ddpm import MLP
    return MLP(config, shape=MLP_SHAPE).eval()
  return registry.get_model(config.model.name)(config).eval()


def _load(model, params):
  with torch.no_grad():
    for name, p in model.named_parameters():
      p.copy_(params[name])
  return model


def _nchw(a):
  return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _score_inputs(family, config, seed=42):
  """(x NHWC, labels) of the JAX importer's tests for each family."""
  rng = np.random.RandomState(seed)
  size, ch = config.data.image_size, config.data.num_channels
  if family in ('ddpm', 'ddpm_sigma'):
    x = rng.uniform(-1, 1, (2, size, size, ch)).astype(np.float32)
    labels = (np.asarray([0, config.model.num_scales - 1], np.int64)
              if family == 'ddpm_sigma'
              else np.asarray([13.7, 981.2], np.float32))
    return x, labels
  if family == 'mlp':
    return (rng.randn(4, size, size, ch).astype(np.float32),
            np.zeros(4, np.float32))
  if family.startswith('ncsnpp_'):
    labels = {'ncsnpp_ve': [0.02, 1.3, 40.0], 'ncsnpp_vp': [0, 7, 19],
              'ncsnpp_skip_sum': [0.5, 5.0], 'ncsnpp_skip_cat': [0.8, 12.0],
              'ncsnpp_ddpm': [1, 13]}[family]
    x = rng.uniform(0.05, 0.95, (len(labels), size, size, ch)
                    ).astype(np.float32)
    if config.data.centered:
      x = 2 * x - 1
    return x, np.asarray(labels, np.float32)
  batch = 1 if family == 'ncsnv2_256' else 2
  x = rng.uniform(0.05, 0.95, (batch, size, size, ch)).astype(np.float32)
  return x, np.arange(batch) % config.model.num_scales


# (family, seed, rtol, atol): the JAX importer's cases.
FORWARD_CASES = [
    ('ddpm', 0, 1e-4, 1e-5), ('ddpm_sigma', 1, 1e-3, 1e-4),
    ('mlp', 3, 1e-4, 1e-5),
    ('ncsnpp_ve', 0, 1e-3, 1e-4), ('ncsnpp_vp', 1, 1e-4, 1e-5),
    ('ncsnpp_skip_sum', 2, 1e-3, 1e-4), ('ncsnpp_skip_cat', 5, 1e-3, 1e-4),
    ('ncsnpp_ddpm', 3, 1e-4, 1e-5),
    ('ncsnv2_64', 0, 1e-3, 1e-4), ('ncsnv2_64_28', 0, 1e-3, 1e-4),
    ('ncsnv2_128', 0, 1e-3, 1e-4), ('ncsnv2_256', 0, 1e-3, 1e-4),
    ('ncsn', 0, 1e-3, 1e-4), ('ncsn_28', 0, 1e-3, 1e-4),
    ('pinn', 0, 1e-3, 1e-4)]


@pytest.mark.parametrize('family,seed,rtol,atol', FORWARD_CASES,
                         ids=[c[0] for c in FORWARD_CASES])
def test_converted_forward_matches_the_oracle(family, seed, rtol, atol):
  _, config = _configs(family)
  oracle = _oracle(family, config, seed)
  params = _convert(family, config, oracle.state_dict())
  model = _load(_port_model(family, config), params)
  if family == 'pinn':
    f1, f2, x, y, t = port_parity.pinn_inputs(batch=2, seed=7)
    with torch.no_grad():
      flow_t, pres_t = oracle(*map(_nchw, (f1, f2, x, y)),
                              torch.from_numpy(t))
      flow_p, pres_p = model(*map(torch.from_numpy, (f1, f2, x, y, t)))
    assert len(flow_p) == len(flow_t) == len(config.model.feature_nums) + 1
    pairs = list(zip(flow_p, flow_t)) + [(pres_p, pres_t)]
  else:
    x, labels = _score_inputs(family, config)
    with torch.no_grad():
      want = oracle(_nchw(x), torch.from_numpy(labels))
      got = model(torch.from_numpy(x), torch.from_numpy(labels),
                  train=False)
    pairs = [(got, want)]
  for got, want in pairs:
    np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(),
                               want.numpy(), rtol=rtol, atol=atol)


def _conv_shortcut(sd):
  """The DDPM state_dict in the reference's ``conv_shortcut`` variant:
  each resblock's ``NIN_0`` replaced by a 3x3 ``Conv_2``."""
  out = {}
  for key, value in sd.items():
    prefix = key.rsplit('.NIN_0.', 1)[0]
    if '.NIN_0.' in key and prefix + '.Conv_1.weight' in sd:
      if key.endswith('.W'):
        cin, cout = value.shape
        out[prefix + '.Conv_2.weight'] = torch.linspace(
            -1, 1, cout * cin * 9).reshape(cout, cin, 3, 3)
      else:
        out[prefix + '.Conv_2.bias'] = value.clone()
      continue
    out[key] = value
  return out


TREE_CASES = [c[0] for c in FORWARD_CASES] + ['ddpm_conv_shortcut']


@pytest.mark.parametrize('family', TREE_CASES)
def test_converted_tree_equals_the_jax_converter(family):
  from b_pinn_kalman_filter_tpu.models import torch_port as jax_port
  base = 'ddpm' if family == 'ddpm_conv_shortcut' else family
  jax_config, config = _configs(base)
  sd = _oracle(base, config, 0).state_dict()
  if family == 'ddpm_conv_shortcut':
    sd = _conv_shortcut(sd)
    got = torch_port.ddpm_params_from_torch_state_dict(sd, config)
    want = jax_port.ddpm_params_from_torch_state_dict(sd, jax_config)
    # The DDPM of either package builds no conv shortcut: compare the
    # trees themselves.
    assert sorted(got) == sorted(torch_port.flatten(want))
    for name, value in torch_port.flatten(want).items():
      assert torch.equal(got[name], torch.from_numpy(np.asarray(value))), name
    assert any('.Conv3x3_2.' in name for name in got)
    with pytest.raises(ValueError, match='stray'):
      torch_port.check_names(got, config)
    return
  if family == 'pinn':
    want = jax_port.pinn_params_from_torch_state_dict(sd, jax_config)
  elif family == 'mlp':
    want = jax_port.mlp_params_from_torch_state_dict(sd, jax_config,
                                                     MLP_SHAPE)
  else:
    want = jax_port.convert_reference_checkpoint({'model': sd},
                                                 jax_config).params
  got = _convert(family, config, sd)
  expected = dict(convert.params_from_jax(
      want, _port_model(family, config)).named_parameters())
  assert sorted(got) == sorted(expected)
  for name, value in expected.items():
    assert got[name].dtype == torch.float32
    assert torch.equal(got[name], value.detach()), name


def _shadows(family, oracle):
  """A distinct EMA shadow list, in ``parameters()`` order, of the
  ``requires_grad`` parameters (the frozen Fourier ``W`` is not one)."""
  params = [p for p in oracle.parameters() if p.requires_grad]
  return [p.detach() * 2.0 + 0.125 for p in params]


EMA_CASES = ['ddpm', 'ncsnpp_ve', 'ncsnv2_64', 'ncsn', 'pinn']


@pytest.mark.parametrize('family', EMA_CASES)
def test_checkpoint_takes_ema_step_and_a_fresh_optimizer(family):
  _, config = _configs(family)
  oracle = _oracle(family, config, 1)
  if family == 'ncsnpp_ve':
    oracle.all_modules[0].W.requires_grad_(False)
  sd = oracle.state_dict()
  ckpt = {'info': 0 if family == 'pinn' else 1, 'model': sd,
          'ema': {'decay': 0.999, 'num_updates': 10,
                  'shadow_params': _shadows(family, oracle)},
          'step': 1234}
  if family == 'pinn':
    ckpt.update(optimizer_1={'state': {}}, optimizer_2={'state': {}})
    state = torch_port.convert_reference_pinn_checkpoint(ckpt, config)
  else:
    ckpt['optimizer'] = {'state': {}}
    state = torch_port.convert_reference_checkpoint(ckpt, config)
  assert state.step == 1234
  direct = (torch_port.pinn_params_from_torch_state_dict(sd, config)
            if family == 'pinn' else
            torch_port.convert_reference_checkpoint({'model': sd},
                                                    config).params)
  for name, value in direct.items():
    assert torch.equal(state.params[name].detach(), value), name
    assert state.params[name].requires_grad
    if name == 'GaussianFourierProjection_0.W':
      assert torch.equal(state.ema_params[name], value)   # frozen
    else:
      torch.testing.assert_close(state.ema_params[name], value * 2 + 0.125,
                                 rtol=0, atol=1e-6)
  groups = ({'flow', 'pres'} if family == 'pinn' else {None})
  opt = state.opt_state if family == 'pinn' else {None: state.opt_state}
  assert set(opt) == groups
  for group in opt.values():
    assert isinstance(group, AdamState) and group.count == 0
    assert all(not v.any() for v in (*group.mu.values(), *group.nu.values()))
  if family == 'pinn':
    assert set(opt['pres'].mu) == {n for n in direct
                                   if n.startswith('pressurenet.')}
  else:
    assert state.ema_rate == config.model.ema_rate


@pytest.mark.parametrize('family', ['ddpm', 'ncsnpp_vp', 'mlp'])
def test_dataparallel_prefix_and_missing_ema(family):
  _, config = _configs(family)
  oracle = _oracle(family, config, 4)
  direct = _convert(family, config, oracle.state_dict())
  sd = torch.nn.DataParallel(oracle).state_dict()
  assert all(k.startswith('module.') for k in sd)
  state = torch_port.convert_reference_checkpoint(
      {'info': 1, 'model': sd, 'step': 7}, config)
  assert state.step == 7
  for name, value in direct.items():
    assert torch.equal(state.params[name].detach(), value)
    assert torch.equal(state.ema_params[name], value)   # no EMA: a copy
    assert state.ema_params[name].data_ptr() != state.params[name].data_ptr()


def test_wrong_input_raises():
  _, config = _configs('ddpm')
  sd = dict(_oracle('ddpm', config, 0).state_dict())
  sd['all_modules.999.weight'] = torch.zeros(1)
  with pytest.raises(ValueError, match='not consumed'):
    torch_port.ddpm_params_from_torch_state_dict(sd, config)
  _, pp_config = _configs('ncsnpp_ve')
  pp_sd = dict(_oracle('ncsnpp_ve', pp_config, 0).state_dict())
  pp_sd['all_modules.999.weight'] = torch.zeros(1)
  with pytest.raises(ValueError, match='not consumed'):
    torch_port.ncsnpp_params_from_torch_state_dict(pp_sd, pp_config)
  with pytest.raises(ValueError, match='dual-optimizer'):
    torch_port.convert_reference_checkpoint({'info': 0, 'model': {}}, config)
  _, pinn_config = _configs('pinn')
  with pytest.raises(ValueError, match='info'):
    torch_port.convert_reference_pinn_checkpoint({'info': 1, 'model': {}},
                                                 pinn_config)
  pinn_sd = dict(_oracle('pinn', pinn_config, 0).state_dict())
  pinn_sd['flownet.extra.weight'] = torch.zeros(1)
  with pytest.raises(ValueError, match='not consumed'):
    torch_port.pinn_params_from_torch_state_dict(pinn_sd, pinn_config)
  pinn_config.model.arch = 'liteflownet'
  with pytest.raises(ValueError, match="arch='flownet'"):
    torch_port.pinn_params_from_torch_state_dict({}, pinn_config)
  del sd['all_modules.999.weight']
  with pytest.raises(ValueError, match='EMA shadow'):
    torch_port.convert_reference_checkpoint(
        {'model': sd, 'ema': {'shadow_params': [torch.zeros(1)]}}, config)
  # A checkpoint of another width: the walk raises on a missing key.
  config.model.nf = 64
  with pytest.raises((KeyError, ValueError)):
    torch_port.convert_reference_checkpoint({'model': sd}, config)


def _overrides():
  """The CLI overrides that cut the flagship config to TINY_DDPM."""
  flat = dict(port_parity.TINY_DDPM)
  flat[('data', 'centered')] = True
  flat[('training', 'batch_size')] = 2
  flat[('training', 'snapshot_freq')] = 10
  return [f'--config.{block}.{key}={value!r}'.replace(' ', '')
          for (block, key), value in flat.items()]


def test_import_tool_workdir_feeds_the_sample_mode(tmp_path):
  path = 'b_pinn_kalman_filter_tpu_torch/configs/vp/cifar10_ddpmpp_continuous.py'
  overrides = _overrides()
  _, config = _configs('ddpm')
  oracle = _oracle('ddpm', config, 2)
  ema = [p.detach() + 0.01 for p in oracle.parameters()]
  torch_ckpt = str(tmp_path / 'checkpoint_3.pth')
  torch.save({'info': 1, 'model': oracle.state_dict(),
              'optimizer': {'state': {}, 'param_groups': [{'lr': 2e-4}]},
              'ema': {'decay': 0.9999, 'num_updates': 25,
                      'shadow_params': ema},
              'step': 25}, torch_ckpt)
  workdir = str(tmp_path / 'migrated')
  assert import_torch_checkpoint.main(
      ['--config', path, '--torch_ckpt', torch_ckpt, '--workdir', workdir]
      + overrides) == 0
  meta = os.path.join(workdir, 'checkpoints-meta', 'checkpoint')
  numbered = os.path.join(workdir, 'checkpoints', 'checkpoint_2')
  assert os.path.exists(meta) and os.path.exists(numbered)
  saved = torch.load(numbered, weights_only=True)
  assert saved['step'] == 25 and saved['opt_state']['count'] == 0
  want = torch_port.convert_reference_checkpoint(torch_ckpt, config)
  for name, value in want.ema_params.items():
    assert torch.equal(saved['ema_params'][name], value)
  assert cli.main(['--config', path, '--workdir', str(tmp_path / 'sample'),
                   '--mode', 'sample', '--ckptdir', numbered,
                   '--device', 'cpu'] + overrides) == 0
  assert os.path.exists(tmp_path / 'sample' / 'sample.png')


def test_imported_pinn_feeds_the_moped_bootstrap(tmp_path):
  _, config = _configs('pinn')
  oracle = _oracle('pinn', config, 3)
  torch_ckpt = str(tmp_path / 'checkpoint_5.pth')
  torch.save({'info': 0, 'model': oracle.state_dict(), 'ema': None,
              'step': 40, 'optimizer_1': {'state': {}},
              'optimizer_2': {'state': {}}}, torch_ckpt)
  config.training.snapshot_freq = 20
  numbered = import_torch_checkpoint.import_checkpoint(
      config, torch_ckpt, str(tmp_path / 'pinn'))
  assert numbered.endswith('checkpoint_2')
  weights = torch_port.pinn_params_from_torch_state_dict(
      oracle.state_dict(), config)
  model = PINN(config)
  state = create_train_state(
      bayes.flatten_posterior(bayes.make_bpinn_params(
          bayes.by_key({k: p.detach().clone()
                        for k, p in model.named_parameters()}),
          config, pretrained=False)),
      pinn_losses.get_pinn_optimizer(config, lr_mul_pres=0.05,
                                     is_bpinn=True), config.model.ema_rate)
  state = ckpt_lib.restore_bpinn_checkpoint(
      numbered, str(tmp_path / 'bpinn_meta'), state, config)
  moped = bayes.flatten_posterior(bayes.make_bpinn_params(
      bayes.by_key(weights), config, pretrained=True))
  for name, value in moped.items():
    assert torch.equal(state.params[name].detach(), value), name
  for name, value in weights.items():   # mu: the imported weights as such
    key, rest = name.split('.', 1)
    assert torch.equal(state.params[f'{key}.mu.{rest}'].detach(), value)
