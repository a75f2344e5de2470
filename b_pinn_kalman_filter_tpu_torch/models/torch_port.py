"""Import the reference's PyTorch checkpoints (``checkpoint_N.pth``).

Counterpart of the JAX package's ``models/torch_port.py``, with the same
walks.  The reference saves ``{'info', 'optimizer' (or 'optimizer_1' and
'optimizer_2'), 'model': state_dict, 'ema': {'decay', 'num_updates',
'shadow_params'}, 'step'}`` (reference utils.py:109-128).  Its score models
are flat ``nn.ModuleList``s walked with a manual index (``all_modules.{i}
.GroupNorm_0.weight``) or attribute-named RefineNets (``res2.0.conv1
.weight``); each converter here replays the reference's construction order
against the flax names that the port's modules carry, and returns the
port's ``{flax name: float32 tensor}`` dict, the names of the model's
``named_parameters()``:

* Conv2d OIHW weights -> HWIO kernels (``permute(2, 3, 1, 0)``);
* Linear ``(out, in)`` weights -> Dense ``(in, out)`` kernels;
* GroupNorm ``weight``/``bias`` -> ``scale``/``bias``;
* NIN ``W``/``b``, InstanceNorm++ ``alpha``/``gamma``/``beta`` and the
  Fourier ``W`` pass through;
* the ``sigmas`` buffer is dropped (the port computes it from the config).

EMA shadow tensors are a flat list in ``model.parameters()`` order
(reference models/ema.py:29-30), which is the state-dict order without
``sigmas`` (and without the frozen Fourier ``W``): the EMA converts by
substituting them and walking again.

The optimizer state does not convert: torch Adam's moments are in the
OIHW layout and the reference's schedule, so an imported run starts a
fresh Adam (and the PINN its two) from the imported weights.  Every
converter raises ``ValueError`` on a key that its walk leaves unconsumed.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch.train.state import (TrainState,
                                                        create_train_state)

Tree = Dict[str, Any]


def _t(value) -> torch.Tensor:
  """A state-dict value as a float32 CPU tensor of its own."""
  return torch.as_tensor(value).detach().to('cpu', torch.float32).clone()


def flatten(tree: Tree, prefix: str = '') -> Dict[str, torch.Tensor]:
  """A nested ``{flax scope: ...}`` tree as ``{dotted name: tensor}``."""
  out = {}
  for key, value in tree.items():
    if isinstance(value, dict):
      out.update(flatten(value, f'{prefix}{key}.'))
    else:
      out[f'{prefix}{key}'] = value
  return out


def strip_module_prefix(state_dict: Dict[str, Any]) -> Dict[str, Any]:
  """Drop the ``module.`` prefix torch.nn.DataParallel adds to every key
  (the reference wraps every score model in it, reference
  models/utils.py:93); an unwrapped state_dict passes through."""
  if state_dict and all(k.startswith('module.') for k in state_dict):
    return {k[len('module.'):]: v for k, v in state_dict.items()}
  return dict(state_dict)


def _check_consumed(keys, used: set, what: str) -> None:
  unconsumed = sorted(k for k in keys if k not in used)
  if unconsumed:
    raise ValueError(
        f'torch state_dict keys not consumed by the {what} '
        f'(checkpoint/config mismatch?): {unconsumed[:8]}'
        f'{" ..." if len(unconsumed) > 8 else ""}')


def _conv(sd, prefix: str, used: set) -> Tree:
  used.add(prefix + '.weight')
  out = {'kernel': _t(sd[prefix + '.weight']).permute(2, 3, 1, 0)
                                               .contiguous()}
  if prefix + '.bias' in sd:
    used.add(prefix + '.bias')
    out['bias'] = _t(sd[prefix + '.bias'])
  return out


def _linear(sd, prefix, used) -> Tree:
  used.update((prefix + '.weight', prefix + '.bias'))
  return {'kernel': _t(sd[prefix + '.weight']).t().contiguous(),
          'bias': _t(sd[prefix + '.bias'])}


def _groupnorm(sd, prefix, used) -> Tree:
  used.update((prefix + '.weight', prefix + '.bias'))
  return {'scale': _t(sd[prefix + '.weight']),
          'bias': _t(sd[prefix + '.bias'])}


def _nin(sd, prefix, used) -> Tree:
  used.update((prefix + '.W', prefix + '.b'))
  return {'W': _t(sd[prefix + '.W']), 'b': _t(sd[prefix + '.b'])}


def _attn(sd, p, used) -> Tree:
  return {'GroupNorm_0': _groupnorm(sd, p + '.GroupNorm_0', used),
          **{f'NIN_{i}': _nin(sd, f'{p}.NIN_{i}', used) for i in range(4)}}


# ---------------------------------------------------------------------------
# DDPM
# ---------------------------------------------------------------------------

def _ddpm_walk(config) -> List[Tuple[int, str, str, dict]]:
  """``(torch index, kind, flax name, extra)`` for every module, in the
  reference's ``all_modules`` order (reference models/ddpm.py:58-106),
  which is also the order the port's ``DDPM`` creates them."""
  nf = config.model.nf
  ch_mult = config.model.ch_mult
  num_res_blocks = config.model.num_res_blocks
  attn_resolutions = config.model.attn_resolutions
  resamp_with_conv = config.model.resamp_with_conv
  num_resolutions = len(ch_mult)
  all_res = [config.data.image_size // (2 ** i) for i in range(num_resolutions)]

  if not config.model.conditional:
    # The reference DDPM builds its module list only when conditional
    # (reference models/ddpm.py:58-65), so no other checkpoint exists.
    raise ValueError('reference DDPM checkpoints are always conditional')

  entries: List[Tuple[int, str, str, dict]] = []
  counters: Dict[str, int] = {}

  def emit(kind: str, flax_type: str, **extra):
    n = counters.get(flax_type, 0)
    counters[flax_type] = n + 1
    entries.append((len(entries), kind, f'{flax_type}_{n}', extra))

  emit('linear', 'Dense')
  emit('linear', 'Dense')
  emit('conv', 'Conv3x3')

  hs_c = [nf]
  in_ch = nf
  for i_level in range(num_resolutions):
    for _ in range(num_res_blocks):
      out_ch = nf * ch_mult[i_level]
      emit('resblock', 'ResnetBlockDDPM', in_ch=in_ch, out_ch=out_ch)
      in_ch = out_ch
      if all_res[i_level] in attn_resolutions:
        emit('attn', 'AttnBlock')
      hs_c.append(in_ch)
    if i_level != num_resolutions - 1:
      emit('downsample', 'Downsample', with_conv=resamp_with_conv)
      hs_c.append(in_ch)

  emit('resblock', 'ResnetBlockDDPM', in_ch=in_ch, out_ch=in_ch)
  emit('attn', 'AttnBlock')
  emit('resblock', 'ResnetBlockDDPM', in_ch=in_ch, out_ch=in_ch)

  for i_level in reversed(range(num_resolutions)):
    for _ in range(num_res_blocks + 1):
      out_ch = nf * ch_mult[i_level]
      emit('resblock', 'ResnetBlockDDPM',
           in_ch=in_ch + hs_c.pop(), out_ch=out_ch)
      in_ch = out_ch
    if all_res[i_level] in attn_resolutions:
      emit('attn', 'AttnBlock')
    if i_level != 0:
      emit('upsample', 'Upsample', with_conv=resamp_with_conv)

  assert not hs_c
  emit('groupnorm', 'GroupNorm')
  emit('conv', 'Conv3x3')
  return entries


def ddpm_params_from_torch_state_dict(state_dict: Dict[str, Any],
                                      config) -> Dict[str, torch.Tensor]:
  """Reference 'ddpm' state_dict -> the port's ``{flax name: tensor}``.

  A width-changing resblock's shortcut is ``NIN_0``, or ``Conv_2`` (as
  ``Conv3x3_2``) in the reference's ``conv_shortcut`` variant, which its
  DDPM never builds (reference layers.py:633-636)."""
  sd = strip_module_prefix(state_dict)
  used: set = set()
  params: Tree = {}

  def conv(p):
    return {'Conv_0': _conv(sd, p, used)}

  for torch_idx, kind, name, extra in _ddpm_walk(config):
    p = f'all_modules.{torch_idx}'
    if kind == 'linear':
      params[name] = _linear(sd, p, used)
    elif kind == 'conv':
      params[name] = conv(p)
    elif kind == 'groupnorm':
      params[name] = _groupnorm(sd, p, used)
    elif kind == 'attn':
      params[name] = _attn(sd, p, used)
    elif kind == 'downsample':
      if extra['with_conv']:
        params[name] = conv(p + '.Conv_0')
    elif kind == 'upsample':
      if extra['with_conv']:
        params[name] = {'Conv3x3_0': conv(p + '.Conv_0')}
    else:  # resblock
      block = {'GroupNorm_0': _groupnorm(sd, p + '.GroupNorm_0', used),
               'Conv3x3_0': conv(p + '.Conv_0'),
               'Dense_0': _linear(sd, p + '.Dense_0', used),
               'GroupNorm_1': _groupnorm(sd, p + '.GroupNorm_1', used),
               'Conv3x3_1': conv(p + '.Conv_1')}
      if extra['in_ch'] != extra['out_ch']:
        if p + '.NIN_0.W' in sd:
          block['NIN_0'] = _nin(sd, p + '.NIN_0', used)
        else:
          block['Conv3x3_2'] = conv(p + '.Conv_2')
      params[name] = block

  _check_consumed([k for k in sd if k.startswith('all_modules.')], used,
                  'architecture walk')
  return flatten(params)


# ---------------------------------------------------------------------------
# NCSN++
# ---------------------------------------------------------------------------

def _fir_conv2d(sd, prefix, used) -> Tree:
  """up_or_down_sampling.Conv2d (reference up_or_down_sampling.py:23-56):
  ``weight`` (O, I, kH, kW) -> the port's ``Conv2d_0`` ``weight`` HWIO."""
  used.add(prefix + '.weight')
  out = {'weight': _t(sd[prefix + '.weight']).permute(2, 3, 1, 0)
                                               .contiguous()}
  if prefix + '.bias' in sd:
    used.add(prefix + '.bias')
    out['bias'] = _t(sd[prefix + '.bias'])
  return out


def _ncsnpp_walk(config) -> List[Tuple[Optional[int], str, str, dict]]:
  """``(torch index, kind, flax name, extra)`` in the reference NCSN++'s
  ``all_modules`` order (reference models/ncsnpp.py:68-230), the port's
  creation order.  The progressive pyramid's resamplers without a conv
  (the reference's ``pyramid_upsample`` / ``pyramid_downsample``, outside
  ``all_modules``) take a flax name and no torch index; the temb Denses
  exist only when ``conditional``, the Fourier projection only with
  ``embedding_type='fourier'``."""
  m = config.model
  nf = m.nf
  ch_mult = m.ch_mult
  num_res_blocks = m.num_res_blocks
  attn_resolutions = m.attn_resolutions
  resamp_with_conv = m.resamp_with_conv
  num_resolutions = len(ch_mult)
  all_res = [config.data.image_size // (2 ** i) for i in range(num_resolutions)]
  resblock_type = m.resblock_type.lower()
  progressive = m.progressive.lower()
  progressive_input = m.progressive_input.lower()
  embedding_type = m.embedding_type.lower()
  combine_method = m.progressive_combine.lower()
  resblock_cls = ('ResnetBlockBigGANpp' if resblock_type == 'biggan'
                  else 'ResnetBlockDDPMpp')

  entries: List[Tuple[Optional[int], str, str, dict]] = []
  counters: Dict[str, int] = {}
  idx = 0

  def flax_name(flax_type: str) -> str:
    n = counters.get(flax_type, 0)
    counters[flax_type] = n + 1
    return f'{flax_type}_{n}'

  def emit(kind: str, flax_type: str, **extra):
    nonlocal idx
    entries.append((idx, kind, flax_name(flax_type), extra))
    idx += 1

  def resblock(in_ch, out_ch, up=False, down=False):
    if resblock_type == 'biggan':
      shortcut = 'conv1x1' if (in_ch != out_ch or up or down) else None
    else:
      shortcut = 'nin' if in_ch != out_ch else None
    emit('resblock', resblock_cls, shortcut=shortcut,
         conditional=m.conditional)

  if embedding_type == 'fourier':
    emit('fourier', 'GaussianFourierProjection')
  if m.conditional:
    emit('linear', 'Dense')
    emit('linear', 'Dense')

  emit('conv3x3', 'Conv3x3')
  hs_c = [nf]
  in_ch = nf

  for i_level in range(num_resolutions):
    for _ in range(num_res_blocks):
      out_ch = nf * ch_mult[i_level]
      resblock(in_ch, out_ch)
      in_ch = out_ch
      if all_res[i_level] in attn_resolutions:
        emit('attn', 'AttnBlockpp')
      hs_c.append(in_ch)
    if i_level != num_resolutions - 1:
      if resblock_type == 'ddpm':
        emit('downsample', 'Downsample', with_conv=resamp_with_conv)
      else:
        resblock(in_ch, in_ch, down=True)
      if progressive_input == 'input_skip':
        flax_name('Downsample')        # the pyramid's, without params
        emit('combine', 'Combine')
        if combine_method == 'cat':
          in_ch *= 2
      elif progressive_input == 'residual':
        emit('downsample', 'Downsample', with_conv=True)
      hs_c.append(in_ch)

  resblock(in_ch, in_ch)
  emit('attn', 'AttnBlockpp')
  resblock(in_ch, in_ch)

  for i_level in reversed(range(num_resolutions)):
    for _ in range(num_res_blocks + 1):
      out_ch = nf * ch_mult[i_level]
      resblock(in_ch + hs_c.pop(), out_ch)
      in_ch = out_ch
    if all_res[i_level] in attn_resolutions:
      emit('attn', 'AttnBlockpp')
    if progressive != 'none':
      if i_level == num_resolutions - 1:
        emit('groupnorm', 'GroupNorm')
        emit('conv3x3', 'Conv3x3')
      elif progressive == 'output_skip':
        flax_name('Upsample')          # the pyramid's, without params
        emit('groupnorm', 'GroupNorm')
        emit('conv3x3', 'Conv3x3')
      else:  # 'residual'
        emit('upsample', 'Upsample', with_conv=True)
    if i_level != 0:
      if resblock_type == 'ddpm':
        emit('upsample', 'Upsample', with_conv=resamp_with_conv)
      else:
        resblock(in_ch, in_ch, up=True)

  assert not hs_c
  if progressive != 'output_skip':
    emit('groupnorm', 'GroupNorm')
    emit('conv3x3', 'Conv3x3')
  return entries


def ncsnpp_params_from_torch_state_dict(state_dict: Dict[str, Any],
                                        config) -> Dict[str, torch.Tensor]:
  """Reference 'ncsnpp' state_dict -> the port's ``{flax name: tensor}``
  (reference models/ncsnpp.py:34-381): DDPM and BigGAN resblocks,
  Fourier and positional embeddings, FIR and nearest resampling, every
  progressive and progressive_input pyramid."""
  sd = strip_module_prefix(state_dict)
  used: set = set()
  params: Tree = {}
  fir = config.model.fir

  def conv(p):
    # Conv3x3 and Conv1x1 hold their conv as 'Conv_0'.
    return {'Conv_0': _conv(sd, p, used)}

  def resample(p, up):
    if fir:
      return {'Conv2d_0': _fir_conv2d(sd, p + '.Conv2d_0', used)}
    return {'Conv3x3_0': conv(p + '.Conv_0')} if up else conv(p + '.Conv_0')

  for torch_idx, kind, name, extra in _ncsnpp_walk(config):
    p = f'all_modules.{torch_idx}'
    if kind == 'fourier':
      used.add(p + '.W')
      params[name] = {'W': _t(sd[p + '.W'])}
    elif kind == 'linear':
      params[name] = _linear(sd, p, used)
    elif kind == 'conv3x3':
      params[name] = conv(p)
    elif kind == 'groupnorm':
      params[name] = _groupnorm(sd, p, used)
    elif kind == 'attn':
      params[name] = _attn(sd, p, used)
    elif kind == 'combine':
      params[name] = {'Conv1x1_0': conv(p + '.Conv_0')}
    elif kind in ('downsample', 'upsample'):
      if extra['with_conv']:
        params[name] = resample(p, kind == 'upsample')
    else:  # resblock
      block = {'GroupNorm_0': _groupnorm(sd, p + '.GroupNorm_0', used),
               'Conv3x3_0': conv(p + '.Conv_0'),
               'GroupNorm_1': _groupnorm(sd, p + '.GroupNorm_1', used),
               'Conv3x3_1': conv(p + '.Conv_1')}
      if extra['conditional']:
        block['Dense_0'] = _linear(sd, p + '.Dense_0', used)
      if extra['shortcut'] == 'conv1x1':   # BigGAN (reference layerspp.py:235)
        block['Conv1x1_0'] = conv(p + '.Conv_2')
      elif extra['shortcut'] == 'nin':     # DDPM++ (reference layerspp.py:186)
        block['NIN_0'] = _nin(sd, p + '.NIN_0', used)
      params[name] = block

  _check_consumed([k for k in sd if k.startswith('all_modules.')], used,
                  'NCSN++ architecture walk')
  return flatten(params)


# ---------------------------------------------------------------------------
# NCSNv2 and NCSN
# ---------------------------------------------------------------------------

def _in_plus(sd, prefix, used) -> Tree:
  """InstanceNorm2dPlus (reference normalization.py:157-168): ``alpha``,
  ``gamma`` and ``beta`` carry their names across."""
  out = {'alpha': _t(sd[prefix + '.alpha']),
         'gamma': _t(sd[prefix + '.gamma'])}
  used.update((prefix + '.alpha', prefix + '.gamma'))
  if prefix + '.beta' in sd:
    used.add(prefix + '.beta')
    out['beta'] = _t(sd[prefix + '.beta'])
  return out


def _cond_in_plus(sd, prefix, used) -> Tree:
  """ConditionalInstanceNorm2dPlus (reference normalization.py:186-215):
  ``embed.weight`` (num_classes, 3C) -> ``Embed_0.embedding``."""
  used.add(prefix + '.embed.weight')
  return {'Embed_0': {'embedding': _t(sd[prefix + '.embed.weight'])}}


def _ncsn_conv(sd, prefix, used) -> Tree:
  return {'Conv_0': _conv(sd, prefix, used)}


def _residual_convs(sd, p, used, resample, dilation, adjust_padding,
                    has_shortcut: bool) -> Tree:
  """A (conditional) ResidualBlock's convs (reference layers.py:382-492),
  in the flax call order.  ConvMeanPool holds its conv as ``.conv``, or
  ``.conv.1`` where adjust_padding wraps it in Sequential(ZeroPad2d, conv)
  (reference layers.py:339-349; no reference checkpoint reaches it: the
  28px res4 that passes adjust_padding is dilated)."""
  blk = {'NCSNConv_0': _ncsn_conv(sd, p + '.conv1', used)}
  if resample == 'down' and dilation == 1:
    cm = '.conv.1' if adjust_padding else '.conv'
    blk['ConvMeanPool_0'] = {'NCSNConv_0': _ncsn_conv(sd, p + '.conv2' + cm,
                                                      used)}
    blk['ConvMeanPool_1'] = {'NCSNConv_0': _ncsn_conv(
        sd, p + '.shortcut' + cm, used)}
    return blk
  blk['NCSNConv_1'] = _ncsn_conv(sd, p + '.conv2', used)
  if has_shortcut:
    blk['NCSNConv_2'] = _ncsn_conv(sd, p + '.shortcut', used)
  return blk


def _ncsnv2_residual_block(sd, p, used, resample, dilation, in_eq_out,
                           adjust_padding=False) -> Tree:
  """ResidualBlock (reference layers.py:438-492): the norms, then the
  convs; a dilated 'down' block has a plain ``shortcut`` conv, so has a
  width-changing one."""
  blk = {'InstanceNorm2dPlus_0': _in_plus(sd, p + '.normalize1', used),
         'InstanceNorm2dPlus_1': _in_plus(sd, p + '.normalize2', used)}
  blk.update(_residual_convs(sd, p, used, resample, dilation, adjust_padding,
                             resample == 'down' or not in_eq_out))
  return blk


def _ncsnv2_rcu(sd, p, used, n_blocks, n_stages=2) -> Tree:
  """RCUBlock: torch ``{i+1}_{j+1}_conv`` (reference layers.py:173-186) ->
  ``NCSNConv_k`` in the same order."""
  out, k = {}, 0
  for i in range(n_blocks):
    for j in range(n_stages):
      out[f'NCSNConv_{k}'] = _ncsn_conv(sd, f'{p}.{i + 1}_{j + 1}_conv', used)
      k += 1
  return out


def _ncsnv2_convlist(sd, p, used, n) -> Tree:
  """CRP and MSF blocks: ``convs.{i}`` -> ``NCSNConv_i``."""
  return {f'NCSNConv_{i}': _ncsn_conv(sd, f'{p}.convs.{i}', used)
          for i in range(n)}


def _ncsnv2_refine_block(sd, p, used, n_inputs, end) -> Tree:
  """RefineBlock (reference layers.py:267-300): RCUBlock_0..n-1, MSFBlock_0
  (with more than one input), CRPBlock_0, RCUBlock_n."""
  blk = {}
  for i in range(n_inputs):
    blk[f'RCUBlock_{i}'] = _ncsnv2_rcu(sd, f'{p}.adapt_convs.{i}', used, 2)
  if n_inputs > 1:
    blk['MSFBlock_0'] = _ncsnv2_convlist(sd, f'{p}.msf', used, n_inputs)
  blk['CRPBlock_0'] = _ncsnv2_convlist(sd, f'{p}.crp', used, 2)
  blk[f'RCUBlock_{n_inputs}'] = _ncsnv2_rcu(sd, f'{p}.output_convs', used,
                                            3 if end else 1)
  return blk


def _ncsnv2_layout(config, force_small: bool = False):
  """(res blocks, refines) of the size-dispatched NCSNv2 variant, in the
  flax creation order: ``(torch prefix, resample, dilation, in_eq_out,
  adjust_padding)`` and ``(torch attribute, n_inputs, end)`` (reference
  models/ncsnv2.py:44-99 below 96px, :221-277 to 128px, :315-379 above;
  the 256 variant runs refine31 between refine2 and refine3,
  ncsnv2.py:401-406).  ``force_small`` takes the small topology at any
  size, as the class-conditional NCSN does (reference ncsnv2.py:136-199).
  """
  size = config.data.image_size
  if force_small and size >= 96:
    size = 32
  pair = lambda name, resample=None, dil=1, eq=True, adj=False: [
      (f'{name}.0', resample, dil, eq, adj),
      (f'{name}.1', None, dil, True, False)]
  if size < 96:
    res = (pair('res1') + pair('res2', 'down', eq=False)
           + pair('res3', 'down', dil=2)
           + pair('res4', 'down', dil=4, adj=(size == 28)))
    refines = [('refine1', 1, False), ('refine2', 2, False),
               ('refine3', 2, False), ('refine4', 2, True)]
  elif size <= 128:
    res = (pair('res1') + pair('res2', 'down', eq=False)
           + pair('res3', 'down') + pair('res4', 'down', dil=2, eq=False)
           + pair('res5', 'down', dil=4))
    refines = [('refine1', 1, False), ('refine2', 2, False),
               ('refine3', 2, False), ('refine4', 2, False),
               ('refine5', 2, True)]
  else:
    res = (pair('res1') + pair('res2', 'down', eq=False)
           + pair('res3', 'down') + pair('res31', 'down')
           + pair('res4', 'down', dil=2, eq=False)
           + pair('res5', 'down', dil=4))
    refines = [('refine1', 1, False), ('refine2', 2, False),
               ('refine31', 2, False), ('refine3', 2, False),
               ('refine4', 2, False), ('refine5', 2, True)]
  return res, refines


def ncsnv2_params_from_torch_state_dict(state_dict: Dict[str, Any],
                                        config) -> Dict[str, torch.Tensor]:
  """Reference NCSNv2 state_dict (attribute paths such as
  ``res2.0.conv1.weight``, ``refine3.crp.convs.1.weight``) -> the port's
  ``{flax name: tensor}``, for the variant that the image size picks."""
  sd = strip_module_prefix(state_dict)
  used: set = set()
  params: Tree = {'NCSNConv_0': _ncsn_conv(sd, 'begin_conv', used)}
  res_blocks, refines = _ncsnv2_layout(config)
  for i, (tp, resample, dil, eq, adj) in enumerate(res_blocks):
    params[f'ResidualBlock_{i}'] = _ncsnv2_residual_block(
        sd, tp, used, resample, dil, eq, adj)
  for j, (tp, n_inputs, end) in enumerate(refines):
    params[f'RefineBlock_{j}'] = _ncsnv2_refine_block(sd, tp, used,
                                                      n_inputs, end)
  params['InstanceNorm2dPlus_0'] = _in_plus(sd, 'normalizer', used)
  params['NCSNConv_1'] = _ncsn_conv(sd, 'end_conv', used)
  _check_consumed([k for k in sd if k != 'sigmas'], used, 'NCSNv2 layout')
  return flatten(params)


def _ncsn_cond_residual_block(sd, p, used, resample, dilation,
                              adjust_padding=False) -> Tree:
  """ConditionalResidualBlock (reference layers.py:382-435): the
  unconditional block's convs, embedding norms; its undilated shortcut
  exists only where the widths differ."""
  blk = {'ConditionalInstanceNorm2dPlus_0':
             _cond_in_plus(sd, p + '.normalize1', used),
         'ConditionalInstanceNorm2dPlus_1':
             _cond_in_plus(sd, p + '.normalize2', used)}
  blk.update(_residual_convs(sd, p, used, resample, dilation, adjust_padding,
                             resample == 'down'
                             or p + '.shortcut.weight' in sd))
  return blk


def _ncsn_cond_rcu(sd, p, used, n_blocks, n_stages=2) -> Tree:
  """CondRCUBlock (reference layers.py:197-221): ``{i}_{j}_norm`` and
  ``{i}_{j}_conv`` pairs, interleaved as flax creates them."""
  out, k = {}, 0
  for i in range(n_blocks):
    for j in range(n_stages):
      out[f'ConditionalInstanceNorm2dPlus_{k}'] = _cond_in_plus(
          sd, f'{p}.{i + 1}_{j + 1}_norm', used)
      out[f'NCSNConv_{k}'] = _ncsn_conv(sd, f'{p}.{i + 1}_{j + 1}_conv', used)
      k += 1
  return out


def _ncsn_cond_convlist(sd, p, used, n) -> Tree:
  """CondCRP and CondMSF (reference layers.py:147-170, :243-264): paired
  ``norms.{i}`` and ``convs.{i}``."""
  out = {}
  for i in range(n):
    out[f'ConditionalInstanceNorm2dPlus_{i}'] = _cond_in_plus(
        sd, f'{p}.norms.{i}', used)
    out[f'NCSNConv_{i}'] = _ncsn_conv(sd, f'{p}.convs.{i}', used)
  return out


def _ncsn_cond_refine_block(sd, p, used, n_inputs, end) -> Tree:
  """CondRefineBlock (reference layers.py:303-336)."""
  blk = {}
  for i in range(n_inputs):
    blk[f'CondRCUBlock_{i}'] = _ncsn_cond_rcu(sd, f'{p}.adapt_convs.{i}',
                                              used, 2)
  if n_inputs > 1:
    blk['CondMSFBlock_0'] = _ncsn_cond_convlist(sd, f'{p}.msf', used,
                                                n_inputs)
  blk['CondCRPBlock_0'] = _ncsn_cond_convlist(sd, f'{p}.crp', used, 2)
  blk[f'CondRCUBlock_{n_inputs}'] = _ncsn_cond_rcu(
      sd, f'{p}.output_convs', used, 3 if end else 1)
  return blk


def ncsn_params_from_torch_state_dict(state_dict: Dict[str, Any],
                                      config) -> Dict[str, torch.Tensor]:
  """Reference class-conditional NCSN (v1) state_dict -> the port's
  ``{flax name: tensor}`` (reference models/ncsnv2.py:136-218: the small
  NCSNv2 topology with conditional blocks and embedding norms)."""
  sd = strip_module_prefix(state_dict)
  used: set = set()
  params: Tree = {'NCSNConv_0': _ncsn_conv(sd, 'begin_conv', used)}
  res_blocks, refines = _ncsnv2_layout(config, force_small=True)
  for i, (tp, resample, dil, _eq, adj) in enumerate(res_blocks):
    params[f'ConditionalResidualBlock_{i}'] = _ncsn_cond_residual_block(
        sd, tp, used, resample, dil, adj)
  for j, (tp, n_inputs, end) in enumerate(refines):
    params[f'CondRefineBlock_{j}'] = _ncsn_cond_refine_block(
        sd, tp, used, n_inputs, end)
  params['ConditionalInstanceNorm2dPlus_0'] = _cond_in_plus(
      sd, 'normalizer', used)
  params['NCSNConv_1'] = _ncsn_conv(sd, 'end_conv', used)
  _check_consumed([k for k in sd if k != 'sigmas'], used, 'NCSN layout')
  return flatten(params)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params_from_torch_state_dict(state_dict: Dict[str, Any], config,
                                     shape: Sequence[int] = (1, 3, 3, 1)
                                     ) -> Dict[str, torch.Tensor]:
  """Reference MLP score model (``nn.fc{i}``, reference
  models/ddpm.py:187-202) -> ``Dense_{i}``.  The reference flattens NCHW
  images in CHW order and the port NHWC images in HWC order, so the first
  layer's inputs and the last layer's outputs are permuted: the same
  function of the image."""
  sd = strip_module_prefix(state_dict)
  C = config.data.num_channels
  H = W = config.data.image_size
  # perm[hwc index] = chw index of the same (h, w, c) site.
  hh, ww, cc = np.meshgrid(np.arange(H), np.arange(W), np.arange(C),
                           indexing='ij')
  perm = torch.from_numpy(((cc * H + hh) * W + ww).reshape(-1))
  n_layers = len(shape) - 1
  params = {}
  for i in range(n_layers):
    kernel = _t(sd[f'nn.fc{i}.weight']).t()
    bias = _t(sd[f'nn.fc{i}.bias'])
    if i == 0:
      kernel = kernel[perm, :]
    if i == n_layers - 1:
      kernel = kernel[:, perm]
      bias = bias[perm]
    params[f'Dense_{i}.kernel'] = kernel.contiguous()
    params[f'Dense_{i}.bias'] = bias
  return params


# ---------------------------------------------------------------------------
# The FlowNet-PINN
# ---------------------------------------------------------------------------

def _seq_convs(sd, p, used, flax_names, torch_idx) -> Tree:
  """A Sequential conv stack (conv, LeakyReLU, conv, ...; reference
  models/flownet.py:27-58) -> ``Conv_i``."""
  return {fn: _conv(sd, f'{p}.{ti}', used)
          for fn, ti in zip(flax_names, torch_idx)}


def _plain_double_res(sd, p, used, cin, cout) -> Tree:
  """get_double_res (reference flownet.py:219-224): two ResidualBlocks with
  parameter-free InstanceNorm2d -> DoubleRes's ResidualBlock_{0,1}."""

  def res(pp, rin, rout):
    blk = {'NCSNConv_0': _ncsn_conv(sd, pp + '.conv1', used),
           'NCSNConv_1': _ncsn_conv(sd, pp + '.conv2', used)}
    if rin != rout:
      blk['NCSNConv_2'] = _ncsn_conv(sd, pp + '.shortcut', used)
    return blk

  return {'ResidualBlock_0': res(p + '.0', cin, 2 * cin),
          'ResidualBlock_1': res(p + '.1', 2 * cin, cout)}


def _flow_upsample(sd, prefix, used) -> Tree:
  """Matching.flow_upsample, a ConvTranspose2d(2, 2, 4, stride=2,
  padding=1, groups=2, bias=False) with weight (2, 1, 4, 4) -> the port's
  ``FlowUpsample`` ``weight`` (4, 4, 1, 2): a stride-2 transposed conv is
  the 2x-dilated correlation with the spatially flipped kernel."""
  used.add(prefix + '.weight')
  w = torch.flip(_t(sd[prefix + '.weight'])[:, 0], dims=(1, 2))  # (2, 4, 4)
  return {'weight': w.permute(1, 2, 0).contiguous()[:, :, None, :]}


def _conv_transpose(sd, prefix, used) -> Tree:
  """PressureNet's ConvTranspose2d(ch_i, ch_o, 2, stride=2), weight (I, O,
  kh, kw) -> ``ConvTranspose`` ``kernel`` HWIO, spatially flipped (torch
  scatters, flax's ConvTranspose gathers)."""
  used.update((prefix + '.weight', prefix + '.bias'))
  w = _t(sd[prefix + '.weight']).permute(2, 3, 0, 1)
  return {'kernel': torch.flip(w, dims=(0, 1)).contiguous(),
          'bias': _t(sd[prefix + '.bias'])}


_FIELD = (('Conv_0', 0), ('Conv_1', 2), ('Conv_2', 4), ('Conv_3', 6))


def pinn_params_from_torch_state_dict(state_dict: Dict[str, Any],
                                      config) -> Dict[str, torch.Tensor]:
  """Reference PINN (pinn_kalman/pinn.py:34-114: FlowNet + PressureNet)
  state_dict -> the port's ``{flownet.* / pressurenet.*: tensor}``.

  Only ``model.arch='flownet'`` converts (the reference's LiteFlowNet-PINN
  cannot produce a checkpoint: its forward's signature differs from the
  PINN's call).  The coarsest Matching's ``flow_upsample``, which the
  reference builds and never calls (reference flownet.py:98-117), is
  consumed and dropped."""
  arch = config.model.get('arch', 'flownet')
  if arch != 'flownet':
    raise ValueError(
        f"PINN converter supports arch='flownet' only, got '{arch}'")
  sd = strip_module_prefix(state_dict)
  used: set = set()
  L = len(config.model.feature_nums)

  fe = {f'ConvFeature_{i}': _seq_convs(
      sd, f'flownet.feature_extractor.feature_extractors.{i}', used,
      ('Conv_0', 'Conv_1'), (0, 2)) for i in range(L)}
  flownet: Tree = {'FeatureExtractor_0': fe}
  for j in range(L):
    p = f'flownet.inference_units.{j}'
    matching = {'ConvField_0': _seq_convs(sd, p + '.match.corr_conv', used,
                                          *zip(*_FIELD))}
    if j == 0:
      used.add(p + '.match.flow_upsample.weight')
    else:
      matching['FlowUpsample_0'] = _flow_upsample(
          sd, p + '.match.flow_upsample', used)
    flownet[f'InferenceUnit_{j}'] = {
        'Matching_0': matching,
        'SubpixelRefinement_0': {
            'ConvField_0': _seq_convs(sd, p + '.refinement.flow_conv', used,
                                      *zip(*_FIELD))}}
  flownet['FinalUpsample_0'] = {'ConvUp_0': _seq_convs(
      sd, 'flownet.upsample.up', used, ('Conv_0', 'Conv_1', 'Conv_2'),
      (0, 2, 4))}

  ch = list(config.model.feature_nums)
  ff = 32
  pn: Tree = {
      'DoubleRes_0': _plain_double_res(sd, 'pressurenet.flow_feature', used,
                                       3, ff),
      'DoubleRes_1': _plain_double_res(sd, 'pressurenet.first', used, ff,
                                       ch[0])}
  for i in range(L - 1):   # down.{i} = Sequential(MaxPool2d, double_res)
    pn[f'DoubleRes_{2 + i}'] = _plain_double_res(
        sd, f'pressurenet.down.{i}.1', used, ch[i], ch[i + 1])
  for i, ch_o in enumerate(ch[-2::-1]):
    pn[f'ConvTranspose_{i}'] = _conv_transpose(sd, f'pressurenet.up.{i}.0',
                                               used)
    pn[f'DoubleRes_{L + 1 + i}'] = _plain_double_res(
        sd, f'pressurenet.up_conv.{i}', used, ch_o * 2 + ff, ch_o)
  pn[f'DoubleRes_{2 * L}'] = _plain_double_res(sd, 'pressurenet.end.0', used,
                                               ch[0], ch[0] // 2)
  pn['Conv_0'] = _conv(sd, 'pressurenet.end.1', used)
  pn[f'DoubleRes_{2 * L + 1}'] = _plain_double_res(sd, 'pressurenet.end.2',
                                                   used, ch[0] // 2, 1)
  pn['Conv_1'] = _conv(sd, 'pressurenet.end.3', used)

  _check_consumed(sd, used, 'PINN layout')
  return flatten({'flownet': flownet, 'pressurenet': pn})


# ---------------------------------------------------------------------------
# EMA and whole checkpoints
# ---------------------------------------------------------------------------

def substitute_ema_shadow(state_dict: Dict[str, Any],
                          ema_state: Dict[str, Any],
                          extra_exclude: Sequence[str] = ()
                          ) -> Dict[str, Any]:
  """``state_dict`` with the EMA shadow tensors in place of the
  parameters.  ``shadow_params`` lists the ``requires_grad`` parameters in
  ``model.parameters()`` order (reference models/ema.py:28-29): the
  state-dict order without the ``sigmas`` buffer, and without whatever
  ``extra_exclude`` names (the frozen Fourier ``W`` of NCSN++, reference
  layerspp.py:37)."""
  shadows = list(ema_state['shadow_params'])
  exclude = {'sigmas', *extra_exclude}
  param_keys = [k for k in state_dict if k not in exclude]
  if len(param_keys) != len(shadows):
    raise ValueError(
        f'{len(shadows)} EMA shadow tensors vs {len(param_keys)} params')
  out = dict(state_dict)
  out.update(zip(param_keys, shadows))
  return out


def load(ckpt: Any) -> Dict[str, Any]:
  """A reference checkpoint: a path is read with ``torch.load(...,
  weights_only=True)`` (the payload holds dicts, lists, tensors and
  numbers only), a loaded dict passes through."""
  if isinstance(ckpt, (str, os.PathLike)):
    return torch.load(ckpt, map_location='cpu', weights_only=True)
  return ckpt


def _model_params(config, pinn: bool) -> Dict[str, torch.Tensor]:
  """The port model's parameters of ``config``, built on the meta device
  (names and shapes, no storage)."""
  with torch.device('meta'):
    if pinn:
      from b_pinn_kalman_filter_tpu_torch.pinn.pinn import PINN
      model = PINN(config)
    else:
      from b_pinn_kalman_filter_tpu_torch.models import registry
      model = registry.get_model(config.model.name)(config)
  return dict(model.named_parameters())


def check_names(params: Dict[str, torch.Tensor], config,
                pinn: bool = False) -> None:
  """Raise ``ValueError`` unless ``params`` names every parameter of the
  port's model of ``config`` and nothing else, each with its shape."""
  want = _model_params(config, pinn)
  stray = sorted(set(params) - set(want))
  missing = sorted(set(want) - set(params))
  if stray or missing:
    raise ValueError(f'converted names differ from the model\'s: stray '
                     f'{stray[:5]}, missing {missing[:5]}')
  for name, p in want.items():
    if tuple(params[name].shape) != tuple(p.shape):
      raise ValueError(f'{name}: converted shape '
                       f'{tuple(params[name].shape)} != model shape '
                       f'{tuple(p.shape)}')


def _state(ckpt, convert, config, tx, ema_exclude=(), pinn=False
           ) -> TrainState:
  sd = strip_module_prefix(ckpt['model'])
  params = convert(sd)
  check_names(params, config, pinn)
  if ckpt.get('ema') is not None:
    ema_params = convert(substitute_ema_shadow(sd, ckpt['ema'],
                                               extra_exclude=ema_exclude))
  else:
    ema_params = {k: v.clone() for k, v in params.items()}
  state = create_train_state(params, tx, config.model.ema_rate)
  state.ema_params = ema_params
  state.step = int(ckpt.get('step', 0))
  return state


def convert_reference_checkpoint(ckpt: Any, config,
                                 tx: Optional[Any] = None) -> TrainState:
  """A reference score-model checkpoint (``info == 1``; a path or the
  loaded payload) -> the port's ``TrainState``: the converted params and
  EMA, the saved ``step``, and a fresh optimizer state (``tx``, by default
  ``core/losses.py`` ``get_optimizer(config)``).  The converter follows
  ``config.model.name``."""
  ckpt = load(ckpt)
  if ckpt.get('info', 1) != 1:
    raise ValueError(
        'info!=1 is the dual-optimizer PINN layout (reference '
        'utils.py:111-120); use convert_reference_pinn_checkpoint')
  name = config.model.name
  ema_exclude: Tuple[str, ...] = ()
  if name == 'mlp':
    convert = lambda d: mlp_params_from_torch_state_dict(d, config)
  elif name == 'ncsnpp':
    convert = lambda d: ncsnpp_params_from_torch_state_dict(d, config)
    if config.model.embedding_type.lower() == 'fourier':
      # The frozen W (all_modules.0) is not in the EMA's shadow list.
      ema_exclude = ('all_modules.0.W',)
  elif name in ('ncsnv2_64', 'ncsnv2_128', 'ncsnv2_256'):
    convert = lambda d: ncsnv2_params_from_torch_state_dict(d, config)
  elif name == 'ncsn':
    convert = lambda d: ncsn_params_from_torch_state_dict(d, config)
  else:
    convert = lambda d: ddpm_params_from_torch_state_dict(d, config)
  if tx is None:
    from b_pinn_kalman_filter_tpu_torch.core import losses
    tx = losses.get_optimizer(config)
  return _state(ckpt, convert, config, tx, ema_exclude)


def convert_reference_pinn_checkpoint(ckpt: Any, config,
                                      tx: Optional[Any] = None
                                      ) -> TrainState:
  """A reference PINN checkpoint (``info == 0``: 'model', 'ema', 'step',
  'optimizer_1', 'optimizer_2', reference utils.py:48-54) -> the port's
  ``TrainState`` over ``flownet.*`` and ``pressurenet.*``, with both
  torch optimizer states replaced by a fresh ``pinn/losses.py``
  ``get_pinn_optimizer(config)`` state (or ``tx``'s)."""
  ckpt = load(ckpt)
  if ckpt.get('info', 0) != 0:
    raise ValueError('info!=0 is the single-optimizer score-model layout; '
                     'use convert_reference_checkpoint')
  if tx is None:
    from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
    tx = pinn_losses.get_pinn_optimizer(config)
  return _state(ckpt, lambda d: pinn_params_from_torch_state_dict(d, config),
                config, tx, pinn=True)
