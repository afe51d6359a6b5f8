"""Multi-axis mesh specs (ref: ``mxnet_tpu/parallel/spmd/mesh.py``), the
shape rules only.

The mesh SHAPE -- which named axes exist and how many devices each gets --
is configuration: ``MXTPU_MESH_SHAPE=dp=4,mp=2`` names it, this module
parses and validates it, and ``parallel.mesh.make_mesh`` realizes it over
the ranks.  The axis alphabet is fixed so a typo is a loud error:

- ``dcn``: the cross-slice/process data axis (outermost);
- ``dp``: data parallel (the batch and ZeRO-1 optimizer states shard here);
- ``mp``: model/tensor parallel;
- ``pp``: pipeline stages.

``pick_mesh_shape`` (the elastic-resize rule) comes with part 3 of the
distributed slice and raises naming it.
"""
from __future__ import annotations

from ...base import MXNetError, getenv

# the axis vocabulary, outermost first: ranks map to axes in this order
AXIS_ORDER = ("dcn", "dp", "mp", "pp")


def parse_mesh_shape(spec):
    """``"dp=4,mp=2"`` -> ``{"dp": 4, "mp": 2}`` (ref: mesh.py:39).

    Accepts a dict (validated and passed through) or a spec string.  Loud
    errors: empty or malformed entries, an axis outside
    :data:`AXIS_ORDER`, a duplicate axis, a size below 1, or axes out of
    the canonical order."""
    if isinstance(spec, dict):
        items = [(str(k), v) for k, v in spec.items()]
    else:
        text = str(spec).strip()
        if not text:
            raise MXNetError(
                "empty mesh shape — expected e.g. 'dp=4,mp=2' "
                f"(axes from {AXIS_ORDER})")
        items = []
        for part in text.split(","):
            part = part.strip()
            if "=" not in part:
                raise MXNetError(
                    f"malformed mesh-shape entry {part!r} in {spec!r} "
                    "— expected axis=size, e.g. 'dp=4,mp=2'")
            name, _, val = part.partition("=")
            items.append((name.strip(), val.strip()))
    shape = {}
    for name, val in items:
        if name not in AXIS_ORDER:
            raise MXNetError(
                f"unknown mesh axis {name!r} in {spec!r} — the axis "
                f"alphabet is {AXIS_ORDER} (dcn=cross-slice data, "
                "dp=data, mp=tensor, pp=pipeline)")
        if name in shape:
            raise MXNetError(f"duplicate mesh axis {name!r} in {spec!r}")
        try:
            size = int(val)
        except (TypeError, ValueError):
            raise MXNetError(
                f"mesh axis {name!r} size {val!r} is not an integer "
                f"(in {spec!r})") from None
        if size < 1:
            raise MXNetError(
                f"mesh axis {name!r} size must be >= 1, got {size} "
                f"(in {spec!r})")
        shape[name] = size
    order = [a for a in AXIS_ORDER if a in shape]
    if list(shape) != order:
        raise MXNetError(
            f"mesh axes must follow the canonical order {AXIS_ORDER} "
            f"(outermost first), got {list(shape)} in {spec!r} — two "
            "jobs spelling one shape must agree on device placement")
    return shape


def format_mesh_shape(shape):
    """Inverse of :func:`parse_mesh_shape` (ref: mesh.py:92)."""
    return ",".join(f"{a}={int(n)}" for a, n in shape.items())


def mesh_shape_from_env():
    """``MXTPU_MESH_SHAPE`` as a validated dict, or None when unset (ref:
    mesh.py:98)."""
    spec = getenv("MESH_SHAPE", None)
    if spec is None or not str(spec).strip():
        return None
    return parse_mesh_shape(spec)


def make_spmd_mesh(shape, devices=None):
    """A parsed or spec-string shape as a mesh over the ranks (ref:
    mesh.py:114); its product must equal the number of ranks."""
    from .. import mesh as _mesh

    shape = parse_mesh_shape(shape)
    return _mesh.make_mesh(shape, devices)


def model_axes(shape):
    """The non-data axes of a shape dict (ref: mesh.py:134)."""
    return {a: n for a, n in shape.items() if a in ("mp", "pp")}


def pick_mesh_shape(shape, new_world):
    raise MXNetError("pick_mesh_shape (the elastic-resize shape rule) is not "
                     "ported yet; it comes with part 3 of the distributed "
                     "slice (slice 7, part 3; ROADMAP.md queue 1)")
