"""Small helpers the port keeps its own copy of."""

from __future__ import annotations

__all__ = ["dotdict"]


class dotdict(dict):
    """A dict with attribute access, applied recursively to nested dicts on
    construction and on item assignment."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    @classmethod
    def _wrap(cls, value):
        if isinstance(value, dotdict):
            return value
        if isinstance(value, dict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def as_dict(self):
        """Plain nested dicts and lists (for YAML dumps)."""
        out = {}
        for k, v in self.items():
            if isinstance(v, dotdict):
                out[k] = v.as_dict()
            elif isinstance(v, (list, tuple)):
                out[k] = type(v)(x.as_dict() if isinstance(x, dotdict) else x for x in v)
            else:
                out[k] = v
        return out
