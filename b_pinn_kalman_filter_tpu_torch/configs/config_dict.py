"""A small attribute dictionary standing in for ``ml_collections.ConfigDict``.

The JAX configs are ``ml_collections`` trees; the port keeps the same keys
in this class so that code reads ``config.model.nf`` the same way in both
packages, without depending on ``ml_collections``.
"""

from __future__ import annotations

from typing import Any


class ConfigDict(dict):
  """``dict`` whose keys are also attributes: ``c.a.b`` is ``c['a']['b']``."""

  def __getattr__(self, name: str) -> Any:
    try:
      return self[name]
    except KeyError:
      raise AttributeError(name) from None

  def __setattr__(self, name: str, value: Any) -> None:
    self[name] = value

