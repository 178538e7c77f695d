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
        self._kids = []

    def var(self, name):
        """Get or create `name` here (None until set), returning the
        name, as the reference's ``Scope::Var`` counterpart does."""
        if name not in self._vars:
            self._vars[name] = None
        return name

    def find_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name):
        return self.find_var(name) is not None

    def get(self, name):
        return self.find_var(name)

    def set(self, name, value):
        """Write where the var already exists, else locally."""
        s = self
        while s is not None:
            if name in s._vars:
                s._vars[name] = value
                return
            s = s.parent
        self._vars[name] = value

    def erase(self, name):
        self._vars.pop(name, None)

    def new_scope(self):
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids = []

    def local_var_names(self):
        return list(self._vars)

    def all_var_names(self):
        """This scope's names, then each ancestor's (a shadowed name
        repeats), as the reference lists them."""
        names = []
        s = self
        while s is not None:
            names.extend(s._vars)
            s = s.parent
        return names

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
