"""NCSN++ score network in PyTorch, NHWC.

Counterpart of the JAX package's ``models/ncsnpp.py`` ``NCSNpp``, with its
layer order and flax child names: ``GaussianFourierProjection_0``,
``Dense_0/1``, ``Conv3x3_k``, ``ResnetBlockBigGANpp_k`` (or
``ResnetBlockDDPMpp_k``), ``AttnBlockpp_k``, ``Downsample_k``,
``Upsample_k``, ``Combine_k`` and ``GroupNorm_k``, each counted by class in
the order flax creates them, so the parameters carry across by name.
Every branch of the JAX model is here: BigGAN and DDPM resblocks, FIR and
nearest resampling, the output pyramid (``progressive`` 'none',
'output_skip', 'residual') and the input pyramid (``progressive_input``
'none', 'input_skip', 'residual'), Fourier and positional embeddings,
``scale_by_sigma`` and ``data.centered``.

Kernel sites (``kernels=True``): each resblock's two ``Conv3x3`` (K1,
where ``ops/conv3x3.py`` ``applicable`` holds) and two ``act(GroupNorm)``
(K2).  The first conv (3 input channels) and the last (3 output channels)
fail K1's guard and stay plain, as they stay on XLA's conv in JAX.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from b_pinn_kalman_filter_tpu_torch.device import get_dtype
from b_pinn_kalman_filter_tpu_torch.models import layers, layerspp, registry


@registry.register_model(name='ncsnpp')
class NCSNpp(nn.Module):
  """Config-driven NCSN++ ('ncsnpp' registry name).

  ``kernels`` selects the hand-written kernels (the default) or their
  plain versions at the kernel sites; see ``layerspp``.
  """

  def __init__(self, config, kernels: bool = True):
    super().__init__()
    self.config = config
    m = config.model
    self.act = act = layers.get_act(config)
    nf, ch_mult = m.nf, tuple(m.ch_mult)
    num_res_blocks = m.num_res_blocks
    attn_resolutions = m.attn_resolutions
    num_resolutions = len(ch_mult)
    fir, fir_kernel = m.fir, tuple(m.fir_kernel)
    skip_rescale, init_scale = m.skip_rescale, m.init_scale
    self.resblock_type = resblock_type = m.resblock_type.lower()
    self.progressive = progressive = m.progressive.lower()
    self.progressive_input = progressive_input = m.progressive_input.lower()
    self.embedding_type = embedding_type = m.embedding_type.lower()
    combine_method = m.progressive_combine.lower()
    assert progressive in ('none', 'output_skip', 'residual')
    assert progressive_input in ('none', 'input_skip', 'residual')
    assert embedding_type in ('fourier', 'positional')
    if resblock_type not in ('ddpm', 'biggan'):
      raise ValueError(f'resblock type {resblock_type} unrecognized.')
    if 'tpu' in config and config.tpu.get('remat', False):
      raise NotImplementedError('tpu.remat (recomputing each resblock in '
                                'the backward) is not ported: ROADMAP.md '
                                'A.17')
    dtype = (get_dtype(config.tpu.compute_dtype) if 'tpu' in config
             else torch.float32)
    self.dtype = dtype
    channels = config.data.num_channels
    counters: Dict[str, int] = {}

    def add(module: nn.Module) -> nn.Module:
      kind = type(module).__name__
      n = counters.get(kind, 0)
      counters[kind] = n + 1
      self.add_module(f'{kind}_{n}', module)
      return module

    def resblock(in_ch, out_ch=None, up=False, down=False):
      if resblock_type == 'ddpm':
        return add(layerspp.ResnetBlockDDPMpp(
            act, in_ch, out_ch, temb_dim=temb_dim, dropout=m.dropout,
            skip_rescale=skip_rescale, init_scale=init_scale, dtype=dtype,
            kernels=kernels))
      return add(layerspp.ResnetBlockBigGANpp(
          act, in_ch, out_ch, temb_dim=temb_dim, up=up, down=down,
          dropout=m.dropout, fir=fir, fir_kernel=fir_kernel,
          skip_rescale=skip_rescale, init_scale=init_scale, dtype=dtype,
          kernels=kernels))

    def attention(ch):
      return add(layerspp.AttnBlockpp(ch, skip_rescale=skip_rescale,
                                      init_scale=init_scale, dtype=dtype))

    def conv3x3(in_ch, out_ch, scale=1.0):
      # flax's Conv3x3 without a dtype: f32.
      return add(layers.Conv3x3(in_ch, out_ch, init_scale=scale,
                                kernels=kernels))

    if embedding_type == 'fourier':
      assert config.training.continuous, \
          'Fourier features are only used for continuous training.'
      add(layerspp.GaussianFourierProjection(nf, m.fourier_scale))
      embed_dim = 2 * nf
    else:
      embed_dim = nf
      self.register_buffer('sigmas', torch.tensor(
          registry.get_sigmas(config), dtype=torch.float32),
          persistent=False)
    temb_dim = None
    if m.conditional:
      temb_dim = nf * 4
      add(layers.Dense(embed_dim, temb_dim, dtype=dtype))      # Dense_0
      add(layers.Dense(temb_dim, temb_dim, dtype=dtype))       # Dense_1

    conv3x3(channels, nf)                                       # Conv3x3_0
    # Downsampling path: per level, its (block, attention or None) pairs,
    # its downsampling (a resblock, or a Downsample for 'ddpm'; None at the
    # last level) and the input pyramid's Downsample and Combine.
    self.down = []
    hs_c = [nf]
    in_ch, res = nf, config.data.image_size
    pyramid_ch = channels
    for i_level in range(num_resolutions):
      blocks = []
      for _ in range(num_res_blocks):
        out_ch = nf * ch_mult[i_level]
        block = resblock(in_ch, out_ch)
        in_ch = out_ch
        blocks.append((block, attention(in_ch)
                       if res in attn_resolutions else None))
        hs_c.append(in_ch)
      down = pyramid_down = combine = None
      if i_level != num_resolutions - 1:
        if resblock_type == 'ddpm':
          down = add(layerspp.Downsample(
              in_ch, with_conv=m.resamp_with_conv, fir=fir,
              fir_kernel=fir_kernel))
        else:
          down = resblock(in_ch, down=True)
        res //= 2
        if progressive_input == 'input_skip':
          pyramid_down = add(layerspp.Downsample(
              pyramid_ch, fir=fir, fir_kernel=fir_kernel, with_conv=False))
          combine = add(layerspp.Combine(pyramid_ch, in_ch,
                                         method=combine_method))
          if combine_method == 'cat':
            in_ch *= 2
        elif progressive_input == 'residual':
          pyramid_down = add(layerspp.Downsample(
              pyramid_ch, out_ch=in_ch, fir=fir, fir_kernel=fir_kernel,
              with_conv=True))
          pyramid_ch = in_ch
        hs_c.append(in_ch)
      self.down.append((blocks, down, pyramid_down, combine))

    # Plain lists: the modules in them are registered by add() alone.
    self.mid = [resblock(in_ch), attention(in_ch), resblock(in_ch)]

    # Upsampling path: per level, its blocks, attention, output-pyramid
    # modules and upsampling (None at the top level).
    self.up = []
    for i_level in reversed(range(num_resolutions)):
      blocks = []
      for _ in range(num_res_blocks + 1):
        out_ch = nf * ch_mult[i_level]
        blocks.append(resblock(in_ch + hs_c.pop(), out_ch))
        in_ch = out_ch
      attn = attention(in_ch) if res in attn_resolutions else None
      pyramid = {}
      if progressive == 'output_skip':
        if i_level != num_resolutions - 1:
          pyramid['up'] = add(layerspp.Upsample(
              channels, fir=fir, fir_kernel=fir_kernel, with_conv=False))
        pyramid['norm'] = add(layerspp.gn(in_ch))
        pyramid['conv'] = conv3x3(in_ch, channels, init_scale)
      elif progressive == 'residual':
        if i_level == num_resolutions - 1:
          pyramid['norm'] = add(layerspp.gn(in_ch))
          pyramid['conv'] = conv3x3(in_ch, in_ch)
        else:
          pyramid['up'] = add(layerspp.Upsample(
              pyramid_ch, out_ch=in_ch, fir=fir, fir_kernel=fir_kernel,
              with_conv=True, kernels=kernels))
        pyramid_ch = in_ch
      up = None
      if i_level != 0:
        if resblock_type == 'ddpm':
          up = add(layerspp.Upsample(in_ch, with_conv=m.resamp_with_conv,
                                     fir=fir, fir_kernel=fir_kernel,
                                     kernels=kernels))
        else:
          up = resblock(in_ch, up=True)
        res *= 2
      self.up.append((blocks, attn, pyramid, up))
    assert not hs_c

    # The last GroupNorm (f32) and conv, where no output pyramid ends it.
    self.final = ([] if progressive == 'output_skip' else
                  [add(layerspp.gn(in_ch)),
                   conv3x3(in_ch, channels, init_scale)])

  def forward(self, x, time_cond, train=True, generator=None):
    """``generator`` feeds the resblocks' dropout when ``train``."""
    config = self.config
    act = self.act
    if self.embedding_type == 'fourier':
      used_sigmas = time_cond
      temb = self.GaussianFourierProjection_0(torch.log(used_sigmas))
    else:
      used_sigmas = (self.sigmas[time_cond.long()]
                     if config.model.scale_by_sigma else None)
      temb = layers.get_timestep_embedding(time_cond, config.model.nf)
    if config.model.conditional:
      temb = self.Dense_1(act(self.Dense_0(temb)))
    else:
      temb = None

    if not config.data.centered:
      x = 2 * x - 1.
    x = x.to(self.dtype)

    def resample(module, h):
      if self.resblock_type == 'ddpm':
        return module(h)
      return module(h, temb, train, generator)

    input_pyramid = x if self.progressive_input != 'none' else None
    hs = [self.Conv3x3_0(x)]
    for blocks, down, pyramid_down, combine in self.down:
      for resnet, attn in blocks:
        h = resnet(hs[-1], temb, train, generator)
        if attn is not None:
          h = attn(h)
        hs.append(h)
      if down is None:
        continue
      h = resample(down, hs[-1])
      if self.progressive_input == 'input_skip':
        input_pyramid = pyramid_down(input_pyramid)
        h = combine(input_pyramid, h)
      elif self.progressive_input == 'residual':
        input_pyramid = layerspp.skip_sum(
            pyramid_down(input_pyramid), h, config.model.skip_rescale)
        h = input_pyramid
      hs.append(h)

    h = hs[-1]
    h = self.mid[0](h, temb, train, generator)
    h = self.mid[1](h)
    h = self.mid[2](h, temb, train, generator)

    pyramid = None
    for blocks, attn, pyr, up in self.up:
      for resnet in blocks:
        h = resnet(torch.cat([h, hs.pop()], dim=-1), temb, train, generator)
      if attn is not None:
        h = attn(h)
      if self.progressive == 'output_skip':
        pyramid_h = pyr['conv'](act(pyr['norm'](h)))
        pyramid = (pyramid_h if pyramid is None
                   else pyr['up'](pyramid) + pyramid_h)
      elif self.progressive == 'residual':
        if pyramid is None:
          pyramid = pyr['conv'](act(pyr['norm'](h)))
        else:
          pyramid = layerspp.skip_sum(pyr['up'](pyramid), h,
                                      config.model.skip_rescale)
          h = pyramid
      if up is not None:
        h = resample(up, h)
    assert not hs

    if self.progressive == 'output_skip':
      h = pyramid
    else:
      norm, conv = self.final
      h = conv(act(norm(h.float())))

    h = h.float()
    if config.model.scale_by_sigma:
      h = h / used_sigmas[:, None, None, None]
    return h
