"""Runtime Scope: name -> tensor store (the counterpart of
``paddle_tpu/core/scope.py``).  Values are ``torch.Tensor``s on the
executor's device; a run updates the persistables it writes in place,
in the tensors held here (``core/graph.py``).
"""

import contextlib


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self.parent = parent

    def find_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name):
        return self.find_var(name) is not None

    def set(self, name, value):
        """Write where the var already exists, else locally."""
        s = self
        while s is not None:
            if name in s._vars:
                s._vars[name] = value
                return
            s = s.parent
        self._vars[name] = value

    def local_var_names(self):
        return list(self._vars)

    def visible_vars(self):
        """(name, value) of every var this scope finds: its own and its
        ancestors' that it does not shadow."""
        seen = {}
        s = self
        while s is not None:
            for n, v in s._vars.items():
                seen.setdefault(n, v)
            s = s.parent
        return list(seen.items())


_scope_stack = [Scope()]


def global_scope():
    return _scope_stack[-1]


def _switch_scope(scope):
    prev = _scope_stack[-1]
    _scope_stack[-1] = scope
    return prev


@contextlib.contextmanager
def scope_guard(scope):
    prev = _switch_scope(scope)
    try:
        yield
    finally:
        _switch_scope(prev)
