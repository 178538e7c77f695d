"""Def-use helpers over Program / Block / Operator (the counterpart of
``paddle_tpu/analysis/graph.py``): the one source of the edges that the
pass matcher, the fuse passes, the inference transpiler and the memory
plan read."""

__all__ = ["consumer_map", "consumer_count", "producer_map", "consumer_ops",
           "producer_ops", "def_use_lists"]


def consumer_map(block):
    """name -> [op indices that read it] over one block."""
    consumers = {}
    for i, op in enumerate(block.ops):
        for name in op.input_arg_names():
            consumers.setdefault(name, []).append(i)
    return consumers


def consumer_count(block):
    """name -> number of reading ops."""
    return {n: len(idxs) for n, idxs in consumer_map(block).items()}


def producer_map(block):
    """name -> index of its LAST writing op (a later redefinition
    shadows earlier ones)."""
    prod = {}
    for i, op in enumerate(block.ops):
        for n in op.output_arg_names():
            prod[n] = i
    return prod


def consumer_ops(block):
    """name -> [Operator objects that read it]."""
    consumers = {}
    for op in block.ops:
        for name in op.input_arg_names():
            consumers.setdefault(name, []).append(op)
    return consumers


def producer_ops(block):
    """name -> LAST writing Operator object."""
    prod = {}
    for op in block.ops:
        for n in op.output_arg_names():
            prod[n] = op
    return prod


def def_use_lists(program, block_idx=0):
    """Per-op (defs, uses) sets over one block.  The reference adds a
    sub-block op's external reads to its uses; the port has no op that
    owns a sub-block yet (control flow is ROADMAP A6c), so one raises."""
    block = program.block(block_idx)
    defs, uses = [], []
    for op in block.ops:
        if any(a.startswith("sub_block") for a in op.attrs):
            raise NotImplementedError(
                "def_use_lists: op '%s' owns a sub-block; control flow is "
                "not ported yet (ROADMAP A6c)" % op.type)
        defs.append(set(op.output_arg_names()))
        uses.append(set(op.input_arg_names()))
    return defs, uses
