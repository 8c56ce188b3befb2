"""Modelled-traffic mesh factorisation planner (``topo plan``; the
port's copy of ``tpu_comm/comm/topoplan.py``, same names in the same
order).

``topo.factor_mesh`` picks the near-square factorisation
(``MPI_Dims_create``'s answer, right for cubic domains). But the wire
bytes a factorisation moves depend on the workload: a 2D halo over an
asymmetric grid ``(G_x, G_y)`` on mesh ``(a, b)`` moves ``∝ a·G_y +
b·G_x`` a step (an axis of one rank moves nothing), a reshard pair's
traffic depends on how the candidate overlaps the destination mesh, and
a ring collective's total only on the ring's length along its axis.
Near-square is a poor answer to all three once the mix is skewed
(PAPERS.md arXiv:2005.09521; arXiv:2508.13370: the optimum moves with
``halo_width``/``fuse_steps``).

The search enumerates EVERY ordered factorisation of ``n`` into
``ndims`` axes, scores each with the wire-edge models
(:func:`patterns.halo_edges` / :func:`patterns.deep_halo_edges` /
:func:`patterns.wire_total` for halo arms,
:func:`analysis.commaudit.reshard_edges` for reshard arms, the sweep's
ring and tree conventions for collective arms), and banks the winner in
the plan artifact ``tpu_comm_torch/data/topo_plan.json``. It touches no
device. The same mix gives the JAX package's entry bit for bit, its
``plan_id`` included.

The artifact is generated only, by ``python -m tpu_comm_torch topo
plan``. Mesh construction (``topo.make_cart_mesh`` without a shape)
consults it through the ``TPU_COMM_TOPO_PLAN`` knob and stamps the
winning entry's ``plan_id`` on the ``CartMesh``, from where it joins the
rows' identity as ``topo_plan``: planned and default rows never share a
key.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from pathlib import Path

from tpu_comm_torch.comm import patterns

#: the banked plan artifact, relative to the root of the checkout
PLAN_REL = "tpu_comm_torch/data/topo_plan.json"

#: absolute default path (next to tuned_chunks.json)
PLAN_PATH = Path(__file__).resolve().parent.parent / "data" / "topo_plan.json"

#: dtype vocabulary the mix spec accepts (an itemsize table: the
#: planner needs no array library for it)
ITEMSIZE = {
    "int8": 1, "bfloat16": 2, "float16": 2,
    "float32": 4, "int32": 4, "float64": 8,
}

#: collective ops the mix can declare, with the sweep's bus-factor
#: conventions (bench/sweep.bus_factor): ring allreduce moves
#: 2(m-1)/m of the buffer per chip, ring all-gather forwards m-1
#: blocks per chip, the binomial tree copies the payload m-1 times.
COLLECTIVE_OPS = (
    "ppermute", "allreduce-ring", "allgather-ring", "bcast-tree",
)

#: score floats are rounded to this many decimals before banking, so
#: a recomputation compares exactly (json round-trips Python
#: floats losslessly; rounding only pins the arithmetic noise of the
#: deep-halo per-step division)
_NDIGITS = 3


def _positive_shape(v, what: str) -> tuple[int, ...]:
    t = tuple(int(x) for x in v)
    if not t or any(x < 1 for x in t):
        raise ValueError(f"{what} must be positive ints, got {v!r}")
    return t


@dataclass(frozen=True)
class HaloArm:
    """One halo-exchange workload arm: a (possibly asymmetric) global
    grid stepped under width-``width`` ghost exchange. ``fuse_steps``
    and ``parts`` ride along as identity metadata — partitioning
    splits messages and fusion elides launches, neither moves
    different wire bytes — so declaring them keeps the banked mix
    honest about WHICH driver config the plan was cut for."""

    gshape: tuple[int, ...]
    width: int = 1
    parts: int | None = None
    fuse_steps: int = 1
    periodic: bool = False
    dtype: str = "float32"
    weight: float = 1.0

    def __post_init__(self):
        object.__setattr__(
            self, "gshape", _positive_shape(self.gshape, "halo gshape")
        )
        if self.width < 1:
            raise ValueError(f"halo width must be >= 1, got {self.width}")
        if self.parts is not None and self.parts < 1:
            raise ValueError(f"halo parts must be >= 1, got {self.parts}")
        if self.fuse_steps < 1:
            raise ValueError(
                f"fuse_steps must be >= 1, got {self.fuse_steps}"
            )
        if self.dtype not in ITEMSIZE:
            raise ValueError(
                f"unknown dtype {self.dtype!r} (know {sorted(ITEMSIZE)})"
            )
        if not self.weight > 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")

    def to_dict(self) -> dict:
        d = {
            "kind": "halo", "gshape": list(self.gshape),
            "width": self.width, "fuse_steps": self.fuse_steps,
            "periodic": self.periodic, "dtype": self.dtype,
            "weight": self.weight,
        }
        if self.parts is not None:
            d["parts"] = self.parts
        return d

    def wire_per_step(self, mesh: tuple[int, ...]) -> float | None:
        """Modeled interconnect bytes one timestep moves on ``mesh``
        (``None`` when the mesh cannot host the arm). A ``width > 1``
        arm exchanges one deep window per ``width`` steps
        (``patterns.deep_halo_edges``), amortized here to per-step."""
        if len(self.gshape) != len(mesh):
            return None
        if any(g % m for g, m in zip(self.gshape, mesh)):
            return None  # grid not divisible: mesh cannot host it
        local = tuple(g // m for g, m in zip(self.gshape, mesh))
        if any(ln < self.width for ln in local):
            return None  # ghost wider than the block: no valid slab
        itemsize = ITEMSIZE[self.dtype]
        if self.width > 1:
            edges = patterns.deep_halo_edges(
                local, mesh, self.periodic, itemsize, self.width,
            )
            return patterns.wire_total(edges) / self.width
        edges = patterns.halo_edges(
            local, mesh, self.periodic, itemsize,
            width=1, parts=self.parts,
        )
        return float(patterns.wire_total(edges))


@dataclass(frozen=True)
class ReshardArm:
    """One reshard round trip: the candidate mesh is the SOURCE, the
    declared ``dst_mesh`` the destination, scored as forward + reverse
    (every campaign reshard is paired — data comes back) under the
    declared arm's wire model (``commaudit.reshard_edges``)."""

    gshape: tuple[int, ...]
    dst_mesh: tuple[int, ...]
    arm: str = "sequential"
    dtype: str = "float32"
    weight: float = 1.0

    def __post_init__(self):
        object.__setattr__(
            self, "gshape", _positive_shape(self.gshape, "reshard gshape")
        )
        object.__setattr__(
            self, "dst_mesh",
            _positive_shape(self.dst_mesh, "reshard dst_mesh"),
        )
        if len(self.gshape) != len(self.dst_mesh):
            raise ValueError(
                f"reshard gshape {self.gshape} and dst_mesh "
                f"{self.dst_mesh} must share one ndim"
            )
        if self.arm not in ("naive", "sequential"):
            raise ValueError(
                f"unknown reshard arm {self.arm!r} (naive/sequential)"
            )
        if self.dtype not in ITEMSIZE:
            raise ValueError(
                f"unknown dtype {self.dtype!r} (know {sorted(ITEMSIZE)})"
            )
        if not self.weight > 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")

    def to_dict(self) -> dict:
        return {
            "kind": "reshard", "gshape": list(self.gshape),
            "dst_mesh": list(self.dst_mesh), "arm": self.arm,
            "dtype": self.dtype, "weight": self.weight,
        }

    def wire_per_step(self, mesh: tuple[int, ...]) -> float | None:
        from tpu_comm_torch.analysis import commaudit
        from tpu_comm_torch.comm.reshard import plan_reshard

        if len(self.gshape) != len(mesh):
            return None
        itemsize = ITEMSIZE[self.dtype]
        try:
            fwd = plan_reshard(self.gshape, mesh, self.dst_mesh, itemsize)
            rev = plan_reshard(self.gshape, self.dst_mesh, mesh, itemsize)
        except ValueError:
            return None  # candidate cannot shard the declared grid
        return float(
            patterns.wire_total(commaudit.reshard_edges(fwd, self.arm))
            + patterns.wire_total(commaudit.reshard_edges(rev, self.arm))
        )


@dataclass(frozen=True)
class CollectiveArm:
    """One collective call along mesh axis ``axis`` with a per-chip
    buffer of ``nbytes``: the op runs over every ring of that axis
    (one ring per combination of the other axes' coordinates), so the
    total is the per-ring cost times ``n / mesh[axis]`` rings."""

    op: str
    nbytes: int
    axis: int = 0
    weight: float = 1.0

    def __post_init__(self):
        if self.op not in COLLECTIVE_OPS:
            raise ValueError(
                f"unknown collective op {self.op!r} "
                f"(know {COLLECTIVE_OPS})"
            )
        if self.nbytes < 1:
            raise ValueError(f"nbytes must be >= 1, got {self.nbytes}")
        if self.axis < 0:
            raise ValueError(f"axis must be >= 0, got {self.axis}")
        if not self.weight > 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")

    def to_dict(self) -> dict:
        return {
            "kind": "collective", "op": self.op, "nbytes": self.nbytes,
            "axis": self.axis, "weight": self.weight,
        }

    def wire_per_step(self, mesh: tuple[int, ...]) -> float | None:
        if self.axis >= len(mesh):
            return None
        m = mesh[self.axis]
        rings = 1
        for i, p in enumerate(mesh):
            if i != self.axis:
                rings *= p
        if self.op == "ppermute":
            edges = [
                patterns.Edge(s, d, self.nbytes, self.axis, +1)
                for s, d in patterns.shift_pairs(m, +1, True)
            ]
            per_ring = float(patterns.wire_total(edges))
        elif self.op == "allgather-ring":
            per_ring = float(patterns.wire_total(
                patterns.ring_allgather_edges(m, self.nbytes)
            ))
        elif self.op == "allreduce-ring":
            # reduce-scatter + all-gather of B/m chunks: each of the m
            # chips forwards 2(m-1)/m · B, totalling 2(m-1)·B — the
            # sweep's 2(n-1)/n bus factor summed over the ring
            per_ring = 2.0 * (m - 1) * self.nbytes if m > 1 else 0.0
        else:  # bcast-tree: the binomial tree copies the payload m-1×
            per_ring = float((m - 1) * self.nbytes)
        return rings * per_ring


_KINDS = {"halo": HaloArm, "reshard": ReshardArm, "collective": CollectiveArm}


def arm_from_dict(d: dict):
    """Rehydrate one mix arm from its banked dict (strict: unknown
    kinds or fields raise ``ValueError`` — a check recomputes plans
    from exactly these dicts, so they must parse or fail loudly)."""
    if not isinstance(d, dict):
        raise ValueError(f"mix arm must be an object, got {d!r}")
    kind = d.get("kind")
    cls = _KINDS.get(kind)
    if cls is None:
        raise ValueError(
            f"unknown mix arm kind {kind!r} (know {sorted(_KINDS)})"
        )
    kwargs = {k: v for k, v in d.items() if k != "kind"}
    try:
        return cls(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in kwargs.items()
        })
    except TypeError as e:
        raise ValueError(f"bad {kind} arm {d!r}: {e}") from None


def mix_to_dicts(arms) -> list[dict]:
    """Canonical banked form of a mix: each arm's dict, the list
    sorted by canonical JSON so fingerprints ignore declaration
    order."""
    ds = [a.to_dict() for a in arms]
    return sorted(ds, key=lambda d: json.dumps(d, sort_keys=True))


def mix_fingerprint(n: int, ndims: int, mix: list[dict]) -> str:
    """Short content hash of (device count, ndims, canonical mix) —
    the upsert identity a banked plan answers for."""
    blob = json.dumps(
        {"n_devices": n, "ndims": ndims, "mix": mix}, sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def enumerate_factorizations(n: int, ndims: int) -> list[tuple[int, ...]]:
    """Every ORDERED factorization of ``n`` into ``ndims`` positive
    factors — axis order matters to the score (array axis i shards
    over mesh axis i), so ``(4, 3)`` and ``(3, 4)`` are distinct
    candidates. Deterministic ascending-divisor order."""
    if n < 1 or ndims < 1:
        raise ValueError(f"need n >= 1 and ndims >= 1, got {n}, {ndims}")
    if ndims == 1:
        return [(n,)]
    divs = [d for d in range(1, n + 1) if n % d == 0]
    out: list[tuple[int, ...]] = []
    for d in divs:
        for rest in enumerate_factorizations(n // d, ndims - 1):
            out.append((d,) + rest)
    return out


def score_mesh(arms, mesh: tuple[int, ...]) -> float | None:
    """Weighted modeled wire bytes per step of the whole mix on
    ``mesh``; ``None`` if ANY arm cannot run there (a plan must host
    the full declared workload, not a subset)."""
    total = 0.0
    for arm in arms:
        w = arm.wire_per_step(mesh)
        if w is None:
            return None
        total += arm.weight * w
    return total


#: fields the plan id commits to (everything recomputable from the
#: mix; ``date`` stays outside so regeneration on an unchanged mix is
#: a no-op diff except the date line)
_ID_FIELDS = (
    "n_devices", "ndims", "mesh", "wire_per_step", "default_mesh",
    "default_wire_per_step", "reduction_frac", "candidates",
    "feasible", "mix", "mix_fingerprint",
)


def _plan_id(entry: dict) -> str:
    blob = json.dumps(
        {k: entry[k] for k in _ID_FIELDS}, sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def plan_entry(n: int, ndims: int, arms, date: str | None = None) -> dict:
    """Run the search and build the banked entry for one (n, ndims,
    mix): exhaustive over :func:`enumerate_factorizations`, argmin of
    :func:`score_mesh` with deterministic tie-breaking (prefer the
    ``factor_mesh`` default, then lexicographic — a plan that cannot
    beat the default must BE the default, so consulting it is a
    no-op)."""
    from tpu_comm_torch.topo import factor_mesh

    arms = list(arms)
    if not arms:
        raise ValueError("workload mix is empty — nothing to plan for")
    for a in arms:
        gshape = getattr(a, "gshape", None)
        if gshape is not None and len(gshape) != ndims:
            raise ValueError(
                f"{a.to_dict()['kind']} arm ndim {len(gshape)} != "
                f"plan ndims {ndims}"
            )
        axis = getattr(a, "axis", None)
        if axis is not None and axis >= ndims:
            raise ValueError(
                f"collective axis {axis} out of range for ndims {ndims}"
            )
        dst = getattr(a, "dst_mesh", None)
        if dst is not None:
            prod = 1
            for p in dst:
                prod *= p
            if prod != n:
                raise ValueError(
                    f"reshard dst_mesh {dst} is not over {n} devices"
                )
    default = factor_mesh(n, ndims)
    cands = enumerate_factorizations(n, ndims)
    scored: list[tuple[float, tuple[int, ...]]] = []
    for mesh in cands:
        s = score_mesh(arms, mesh)
        if s is not None:
            scored.append((s, mesh))
    if not scored:
        raise ValueError(
            f"no factorization of {n} into {ndims} axes can host the "
            "declared mix (check grid divisibility and halo width)"
        )
    best_score, best_mesh = min(
        scored,
        key=lambda sm: (sm[0], 0 if sm[1] == default else 1, sm[1]),
    )
    default_score = next((s for s, m in scored if m == default), None)
    mix = mix_to_dicts(arms)
    entry = {
        "n_devices": n,
        "ndims": ndims,
        "mesh": list(best_mesh),
        "wire_per_step": round(best_score, _NDIGITS),
        "default_mesh": list(default),
        "default_wire_per_step": (
            None if default_score is None
            else round(default_score, _NDIGITS)
        ),
        "reduction_frac": (
            None if not default_score
            else round(1.0 - best_score / default_score, 4)
        ),
        "candidates": len(cands),
        "feasible": len(scored),
        "mix": mix,
        "mix_fingerprint": mix_fingerprint(n, ndims, mix),
    }
    entry["plan_id"] = _plan_id(entry)
    if date is not None:
        entry["date"] = date
    return entry


# ------------------------------------------------------ CLI mini-specs

def _parse_shape(tok: str, what: str) -> tuple[int, ...]:
    try:
        return tuple(int(x) for x in tok.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"bad {what} {tok!r} (want e.g. 6144x768)"
        ) from None


def _parse_bytes(tok: str) -> int:
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}
    t = tok.lower()
    try:
        if t and t[-1] in mult:
            return int(float(t[:-1]) * mult[t[-1]])
        return int(t)
    except ValueError:
        raise ValueError(
            f"bad byte size {tok!r} (want e.g. 64k, 8m, 1048576)"
        ) from None


def parse_halo_spec(spec: str) -> HaloArm:
    """``GSHAPE[:wN][:pN][:fN][:periodic][:DTYPE][:xW]`` — e.g.
    ``6144x768:w2:periodic:x200`` is a width-2 periodic halo over an
    asymmetric 2D grid, weighted 200 steps per mix step."""
    toks = spec.split(":")
    kw: dict = {"gshape": _parse_shape(toks[0], "halo gshape")}
    for t in toks[1:]:
        tl = t.lower()
        if tl == "periodic":
            kw["periodic"] = True
        elif tl in ITEMSIZE:
            kw["dtype"] = tl
        elif tl.startswith("w") and tl[1:].isdigit():
            kw["width"] = int(tl[1:])
        elif tl.startswith("p") and tl[1:].isdigit():
            kw["parts"] = int(tl[1:])
        elif tl.startswith("f") and tl[1:].isdigit():
            kw["fuse_steps"] = int(tl[1:])
        elif tl.startswith("x"):
            kw["weight"] = float(tl[1:])
        else:
            raise ValueError(
                f"bad halo token {t!r} in {spec!r} "
                "(know wN/pN/fN/periodic/DTYPE/xW)"
            )
    return HaloArm(**kw)


def parse_reshard_spec(spec: str) -> ReshardArm:
    """``GSHAPE:toMESH[:naive|sequential][:DTYPE][:xW]`` — e.g.
    ``6144x768:to2x6:sequential`` scores the round trip between the
    candidate mesh and ``(2, 6)``."""
    toks = spec.split(":")
    kw: dict = {"gshape": _parse_shape(toks[0], "reshard gshape")}
    for t in toks[1:]:
        tl = t.lower()
        if tl.startswith("to"):
            kw["dst_mesh"] = _parse_shape(tl[2:], "reshard dst mesh")
        elif tl in ("naive", "sequential"):
            kw["arm"] = tl
        elif tl in ITEMSIZE:
            kw["dtype"] = tl
        elif tl.startswith("x"):
            kw["weight"] = float(tl[1:])
        else:
            raise ValueError(
                f"bad reshard token {t!r} in {spec!r} "
                "(know toMESH/naive/sequential/DTYPE/xW)"
            )
    if "dst_mesh" not in kw:
        raise ValueError(
            f"reshard spec {spec!r} needs a destination (:toMESH)"
        )
    return ReshardArm(**kw)


def parse_collective_spec(spec: str) -> CollectiveArm:
    """``OP:NBYTES[:axisN][:xW]`` — e.g. ``allreduce-ring:8m:axis0``
    is an 8 MiB per-chip ring allreduce along mesh axis 0."""
    toks = spec.split(":")
    if len(toks) < 2:
        raise ValueError(
            f"collective spec {spec!r} needs OP:NBYTES"
        )
    kw: dict = {"op": toks[0].lower(), "nbytes": _parse_bytes(toks[1])}
    for t in toks[2:]:
        tl = t.lower()
        if tl.startswith("axis") and tl[4:].isdigit():
            kw["axis"] = int(tl[4:])
        elif tl.startswith("x"):
            kw["weight"] = float(tl[1:])
        else:
            raise ValueError(
                f"bad collective token {t!r} in {spec!r} "
                "(know axisN/xW)"
            )
    return CollectiveArm(**kw)


# ------------------------------------------------------ the artifact

_META = {
    "tool": "python -m tpu_comm_torch topo plan",
    "note": (
        "generated-only; never hand-edit — every entry is recomputed "
        "from its mix and must come out the same"
    ),
}


def load_plans(path: str | os.PathLike | None = None) -> dict:
    """The artifact document (``{"_meta": ..., "plans": [...]}``);
    an absent file reads as an empty table, anything unparsable
    raises ``ValueError`` (callers on the consult path catch it)."""
    p = Path(path) if path is not None else PLAN_PATH
    if not p.is_file():
        return {"_meta": dict(_META), "plans": []}
    doc = json.loads(p.read_text())
    if not isinstance(doc, dict) or not isinstance(
        doc.get("plans"), list
    ):
        raise ValueError(
            f"{p} must carry a top-level 'plans' list"
        )
    return doc


def save_plan(entry: dict, path: str | os.PathLike | None = None) -> Path:
    """Upsert ``entry`` into the artifact, keyed on
    ``(n_devices, ndims)`` — mesh construction looks plans up by
    device count and rank, so exactly one may answer. Atomic
    tmp+rename write (the artifact is git-tracked evidence; a torn
    write must never be bankable)."""
    p = Path(path) if path is not None else PLAN_PATH
    try:
        doc = load_plans(p)
    except ValueError:
        doc = {"_meta": dict(_META), "plans": []}
    key = (entry["n_devices"], entry["ndims"])
    plans = [
        e for e in doc["plans"]
        if (e.get("n_devices"), e.get("ndims")) != key
    ]
    plans.append(entry)
    plans.sort(key=lambda e: (e["n_devices"], e["ndims"]))
    doc = {"_meta": dict(_META), "plans": plans}
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    tmp.replace(p)
    _LOOKUP_CACHE.clear()
    return p


_LOOKUP_CACHE: dict = {}


def lookup(
    n: int, ndims: int, path: str | os.PathLike | None = None,
) -> dict | None:
    """The banked plan for (n devices, ndims), or None. Cached per
    (path, mtime) so the hot mesh-construction path stats instead of
    re-parsing; an unreadable or invalid artifact reads as 'no plan'
    here — a check of the artifact, not the consult path, is where a bad
    artifact fails loudly."""
    p = Path(path) if path is not None else PLAN_PATH
    try:
        mtime = p.stat().st_mtime_ns
    except OSError:
        return None
    ck = (str(p), mtime)
    doc = _LOOKUP_CACHE.get(ck)
    if doc is None:
        try:
            doc = load_plans(p)
        except (ValueError, OSError):
            return None
        _LOOKUP_CACHE.clear()
        _LOOKUP_CACHE[ck] = doc
    for e in doc.get("plans", ()):
        if e.get("n_devices") == n and e.get("ndims") == ndims:
            return e
    return None
