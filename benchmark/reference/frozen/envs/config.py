"""Plain nested configuration for the envs.

Takes the place of ``ml_collections.ConfigDict`` in the JAX envs, with the
same keys: a ``dict`` whose nested dicts are ``Config`` too, readable by
attribute (``cfg.noise_config.level``), and the same flattened-key override
(``update_from_flattened_dict({'noise_config.level': 0.0})``).
"""

from __future__ import annotations

from typing import Any, Mapping


class Config(dict):
  """A nested dict with attribute access; a deep copy of what it is given."""

  def __init__(self, mapping: Mapping[str, Any] = (), **kw):
    super().__init__()
    for k, v in dict(mapping, **kw).items():
      self[k] = v

  def __setitem__(self, key: str, value: Any) -> None:
    if isinstance(value, Mapping):
      value = Config(value)
    elif isinstance(value, (list, tuple)):
      value = list(value)
    super().__setitem__(key, value)

  def __getattr__(self, name: str) -> Any:
    try:
      return self[name]
    except KeyError:
      raise AttributeError(name) from None

  def __setattr__(self, name: str, value: Any) -> None:
    self[name] = value

  def update_from_flattened_dict(self, flat: Mapping[str, Any]) -> None:
    """Set ``a.b.c`` keys; every key must already exist."""
    for path, value in flat.items():
      node = self
      *parents, leaf = path.split('.')
      for p in parents:
        node = node[p]
      if leaf not in node:
        raise KeyError(f'unknown config key {path!r}')
      node[leaf] = value
