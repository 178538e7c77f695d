"""Program pass infrastructure (the counterpart of
``paddle_tpu/transpiler/pass_registry.py``): ``Pass`` /
``register_pass`` / ``get_pass`` / ``apply_pass`` and the ``OpPattern``
chain matcher over a block's def-use graph."""

__all__ = ["Pass", "register_pass", "get_pass", "apply_pass", "OpPattern",
           "consumer_map"]

_PASSES = {}


class Pass:
    """Base class: subclasses implement apply(program, scope=None)."""

    name = None

    def apply(self, program, scope=None):
        raise NotImplementedError

    def __call__(self, program, scope=None):
        return self.apply(program, scope=scope)


def register_pass(name):
    """Decorator registering a Pass subclass or a function
    program -> program under `name`."""

    def deco(obj):
        if isinstance(obj, type) and issubclass(obj, Pass):
            inst = obj()
        else:
            inst = Pass()
            inst.apply = lambda program, scope=None, _f=obj: _f(program, scope)
        inst.name = name
        _PASSES[name] = inst
        return obj

    return deco


def get_pass(name):
    if name not in _PASSES:
        raise KeyError("no pass '%s' registered (known: %s)"
                       % (name, sorted(_PASSES)))
    return _PASSES[name]


def apply_pass(program, name, scope=None):
    """Apply one registered pass; returns the (possibly same) program."""
    out = get_pass(name).apply(program, scope=scope)
    return out if out is not None else program


def consumer_map(block):
    """name -> [op indices that read it] over one block."""
    consumers = {}
    for i, op in enumerate(block.ops):
        for name in op.input_arg_names():
            consumers.setdefault(name, []).append(i)
    return consumers


class OpPattern:
    """A linear chain of op types connected by single-consumer def-use
    edges; ``rewrite`` hands each match to a callback that may mutate
    the block (return True to count a rewrite)."""

    def __init__(self, op_types):
        self.op_types = list(op_types)

    def match(self, block):
        consumers = consumer_map(block)
        for op in block.ops:
            if op.type != self.op_types[0]:
                continue
            chain = [op]
            cur = op
            for want in self.op_types[1:]:
                nxt = None
                for name in cur.output_arg_names():
                    cs = consumers.get(name, [])
                    if len(cs) == 1 and block.ops[cs[0]].type == want:
                        nxt = block.ops[cs[0]]
                        break
                if nxt is None:
                    break
                chain.append(nxt)
                cur = nxt
            if len(chain) == len(self.op_types):
                yield chain

    def rewrite(self, block, fn):
        """Apply fn to every match, re-scanning after each mutation; a
        chain already offered is never offered again."""
        count = 0
        seen = set()
        changed = True
        while changed:
            changed = False
            for chain in self.match(block):
                key = tuple(id(op) for op in chain)
                if key in seen:
                    continue
                seen.add(key)
                if fn(chain):
                    count += 1
                    changed = True
                    break
        return count
