"""Device meshes over ``torch.distributed`` ranks (the counterpart of
``paddle_tpu/parallel/mesh.py``).

The reference's mesh is an array of devices that one program spans, and
``shard_map`` runs a body per device.  Here each rank is a process that
runs its own shard of the program: a ``Mesh`` names the axes and their
sizes, this rank's coordinate on each, and one process group per axis
(the ranks that share every other coordinate), over which the
collectives of that axis run.  Ranks are laid out row-major over the
axes, as the reference reshapes its device list.
"""

import math

import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "default_mesh", "mesh_axis_sizes"]


class Mesh:
    """`axis_names` and `shape` (sizes, in order), this rank's
    coordinate, and the process group of each axis of size > 1 (None
    for an axis of size 1: its collectives are the identity)."""

    def __init__(self, axis_names, sizes, coord, groups):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.coord = dict(zip(self.axis_names, coord))
        self.groups = dict(groups)

    def size(self, axis):
        """Size of `axis`; 1 for an axis the mesh does not have."""
        return int(self.shape.get(axis, 1))

    def index(self, axis):
        """This rank's coordinate on `axis` (0 for an absent axis)."""
        return int(self.coord.get(axis, 0))

    def group(self, axis):
        """The process group of `axis`, None where it has one rank."""
        return self.groups.get(axis)

    def __repr__(self):
        return "Mesh(%s, coord=%s)" % (self.shape, self.coord)


def make_mesh(axes):
    """axes: dict name -> size in order, e.g. {"dp": 1, "mp": 2}; -1 for
    one axis absorbs the remaining ranks.  The sizes must multiply to
    the world size of ``torch.distributed`` (1 when it is not
    initialized: a mesh whose axes are all 1 needs no process group).
    Every rank calls it with the same axes: the groups are created in
    the same order everywhere, as ``new_group`` requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // known
    total = math.prod(sizes)
    if total != world:
        raise ValueError("mesh %s needs %d ranks, the world has %d"
                         % (dict(zip(names, sizes)), total, world))
    coord, r = [], rank
    for s in reversed(sizes):
        coord.append(r % s)
        r //= s
    coord.reverse()
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    groups = {}
    for a, (name, size) in enumerate(zip(names, sizes)):
        if size == 1:
            continue
        # one group per line along axis `a`: every rank whose other
        # coordinates agree; new_group is called for every line, on
        # every rank, in the same order
        for base in range(total):
            if (base // strides[a]) % size:
                continue  # not the first rank of its line
            members = [base + i * strides[a] for i in range(size)]
            g = dist.new_group(members)
            if rank in members:
                groups[name] = g
    return Mesh(names, sizes, coord, groups)


def default_mesh(axis_name="dp"):
    return make_mesh({axis_name: -1})


def mesh_axis_sizes(mesh):
    return dict(mesh.shape)
