"""DDPM U-Net score network in PyTorch.

Counterpart of the JAX package's ``models/ddpm.py`` ``DDPM``, with the same
layer order and the flax child names (``Dense_0``, ``Conv3x3_0``,
``ResnetBlockDDPM_k``, ``AttnBlock_k``, ``Downsample_k``, ``Upsample_k``,
``GroupNorm_0``, ...), so the parameters carry across by name.  NHWC.
Activations are in ``config.tpu.compute_dtype``; the final GroupNorm and
conv run in plain f32, as in JAX.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from b_pinn_kalman_filter_tpu_torch.device import get_dtype
from b_pinn_kalman_filter_tpu_torch.models import layers, registry


@registry.register_model(name='ddpm')
class DDPM(nn.Module):
  """Config-driven DDPM U-Net ('ddpm' registry name).

  ``kernels`` selects the hand-written kernels (the default) or their
  plain versions at the kernel sites; see ``layers``.
  """

  def __init__(self, config, kernels: bool = True):
    super().__init__()
    self.config = config
    self.act = act = layers.get_act(config)
    nf = config.model.nf
    ch_mult = config.model.ch_mult
    num_res_blocks = config.model.num_res_blocks
    attn_resolutions = config.model.attn_resolutions
    resamp_with_conv = config.model.resamp_with_conv
    num_resolutions = len(ch_mult)
    all_res = [config.data.image_size // (2 ** i)
               for i in range(num_resolutions)]
    dtype = (get_dtype(config.tpu.compute_dtype) if 'tpu' in config
             else torch.float32)
    self.dtype = dtype
    counters: Dict[str, int] = {}

    def add(module: nn.Module) -> nn.Module:
      kind = type(module).__name__
      n = counters.get(kind, 0)
      counters[kind] = n + 1
      self.add_module(f'{kind}_{n}', module)
      return module

    def resblock(in_ch, out_ch):
      return add(layers.ResnetBlockDDPM(
          act, in_ch, out_ch, temb_dim=temb_dim,
          dropout=config.model.dropout, dtype=dtype, kernels=kernels))

    temb_dim = None
    if config.model.conditional:
      temb_dim = nf * 4
      add(layers.Dense(nf, temb_dim, dtype=dtype))            # Dense_0
      add(layers.Dense(temb_dim, temb_dim, dtype=dtype))      # Dense_1

    add(layers.Conv3x3(config.data.num_channels, nf,             # Conv3x3_0
                       dtype=dtype, kernels=kernels))
    # Downsampling path: per level, its (block, attention or None) pairs
    # and its downsample (None at the last level).
    self.down = []
    hs_c = [nf]
    in_ch = nf
    for i_level in range(num_resolutions):
      blocks = []
      for _ in range(num_res_blocks):
        out_ch = nf * ch_mult[i_level]
        block = resblock(in_ch, out_ch)
        attn = (add(layers.AttnBlock(out_ch, dtype=dtype))
                if all_res[i_level] in attn_resolutions else None)
        blocks.append((block, attn))
        in_ch = out_ch
        hs_c.append(in_ch)
      down = None
      if i_level != num_resolutions - 1:
        down = add(layers.Downsample(in_ch, with_conv=resamp_with_conv,
                                     dtype=dtype))
        hs_c.append(in_ch)
      self.down.append((blocks, down))

    # Plain lists: the modules in them are registered by add() alone.
    self.mid = [resblock(in_ch, in_ch),
                add(layers.AttnBlock(in_ch, dtype=dtype)),
                resblock(in_ch, in_ch)]

    # Upsampling path: per level, its blocks, attention and upsample.
    self.up = []
    for i_level in reversed(range(num_resolutions)):
      blocks = []
      for _ in range(num_res_blocks + 1):
        out_ch = nf * ch_mult[i_level]
        blocks.append(resblock(in_ch + hs_c.pop(), out_ch))
        in_ch = out_ch
      attn = (add(layers.AttnBlock(in_ch, dtype=dtype))
              if all_res[i_level] in attn_resolutions else None)
      up = (add(layers.Upsample(in_ch, with_conv=resamp_with_conv,
                                dtype=dtype, kernels=kernels))
            if i_level != 0 else None)
      self.up.append((blocks, attn, up))
    assert not hs_c

    add(layers.GroupNorm(in_ch, min(32, in_ch)))                 # GroupNorm_0
    add(layers.Conv3x3(in_ch, config.data.num_channels,           # Conv3x3_1
                       init_scale=0., kernels=False))
    if config.model.scale_by_sigma:
      self.register_buffer('sigmas', torch.tensor(
          registry.get_sigmas(config), dtype=torch.float32),
          persistent=False)

  def forward(self, x, labels, train=True):
    config = self.config
    temb = None
    if config.model.conditional:
      temb = layers.get_timestep_embedding(labels, config.model.nf)
      temb = self.Dense_0(temb)
      temb = self.Dense_1(self.act(temb))

    h = x if config.data.centered else 2 * x - 1.
    h = h.to(self.dtype)

    hs = [self.Conv3x3_0(h)]
    for blocks, down in self.down:
      for block, attn in blocks:
        h = block(hs[-1], temb, train)
        if attn is not None:
          h = attn(h)
        hs.append(h)
      if down is not None:
        hs.append(down(hs[-1]))

    h = hs[-1]
    h = self.mid[0](h, temb, train)
    h = self.mid[1](h)
    h = self.mid[2](h, temb, train)

    for blocks, attn, up in self.up:
      for block in blocks:
        h = block(torch.cat([h, hs.pop()], dim=-1), temb, train)
      if attn is not None:
        h = attn(h)
      if up is not None:
        h = up(h)
    assert not hs

    h = self.act(self.GroupNorm_0(h.float()))
    h = self.Conv3x3_1(h)

    if config.model.scale_by_sigma:
      used_sigmas = self.sigmas[labels.long()]
      h = h / used_sigmas[:, None, None, None]
    return h
