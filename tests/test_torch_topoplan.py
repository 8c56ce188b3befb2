"""The port's topology planner (``tpu_comm_torch/comm/topoplan.py``, the
wire-edge models of ``comm/patterns.py``, ``analysis/commaudit.py``
``reshard_edges``, ``topo.planned_mesh_shape`` and ``topo plan``) held
against the JAX package's, on the CPU, with no tolerance.

- The edge models (``halo_edges``, ``deep_halo_edges``, ``wire_total``,
  ``ring_allgather_edges``, the rank tables) and ``reshard_edges`` on
  every arm: the same edges.
- ``enumerate_factorizations`` for n <= 24 and 1-3 axes; the spec
  parsers' round trips and refusals; ``score_mesh`` on every candidate
  of halo (deep, fused, partitioned), reshard (each arm) and collective
  (each op) arms; ``plan_entry`` on JAX's two banked mixes, a skewed
  8-device halo mix and an 8-device ``ppermute`` mix, every field.
- The committed artifact: every entry recomputed, JAX's two banked
  entries but ``date``, no entry for a mesh of 1, 4 or 8 ranks.
- The ``TPU_COMM_TOPO_PLAN`` knob's states, ``make_cart_mesh`` in this
  process, the artifact's round trip, and the command line against
  JAX's.

The mesh built on 8 gloo ranks and the sweep rows on 4 are held in
``tests/test_torch_dist.py`` and ``tests/test_torch_sweep.py``, whose
rank worlds run them.
"""

import json
import math

import pytest

from tpu_comm import cli as jcli
from tpu_comm import topo as jtopo
from tpu_comm.analysis import commaudit as jcommaudit
from tpu_comm.comm import patterns as jpatterns
from tpu_comm.comm import reshard as jreshard
from tpu_comm.comm import topoplan as jtp
from tpu_comm_torch import cli
from tpu_comm_torch import topo as ptopo
from tpu_comm_torch.analysis import commaudit as pcommaudit
from tpu_comm_torch.comm import patterns as ppatterns
from tpu_comm_torch.comm import reshard as preshard
from tpu_comm_torch.comm import topoplan as ptp

#: JAX's two banked mixes, as ``topo plan`` arguments
BANKED_ARGV = [
    ["--n-devices", "12", "--ndims", "2",
     "--halo", "6144x768:w2:periodic:x200",
     "--reshard", "6144x768:to2x6:sequential"],
    ["--n-devices", "24", "--ndims", "2",
     "--halo", "12288x768:w2:periodic:x200",
     "--reshard", "12288x768:to2x12:sequential"],
]


def _mixes(tp):
    """(n, ndims, arms) of the mixes ``plan_entry`` is held on, built
    from ``tp`` (either package's module)."""
    return {
        "banked12": (12, 2, [
            tp.HaloArm(gshape=(6144, 768), width=2, periodic=True,
                       weight=200.0),
            tp.ReshardArm(gshape=(6144, 768), dst_mesh=(2, 6),
                          arm="sequential")]),
        "banked24": (24, 2, [
            tp.HaloArm(gshape=(12288, 768), width=2, periodic=True,
                       weight=200.0),
            tp.ReshardArm(gshape=(12288, 768), dst_mesh=(2, 12),
                          arm="sequential")]),
        "skewed8": (8, 2, [
            tp.HaloArm(gshape=(8192, 64), width=2, periodic=True)]),
        "ppermute8": (8, 1, [tp.CollectiveArm("ppermute", 1 << 20)]),
        "mixed8x3": (8, 3, [
            tp.HaloArm(gshape=(64, 32, 16), parts=3, fuse_steps=4,
                       dtype="bfloat16", weight=10.0),
            tp.ReshardArm(gshape=(64, 32, 16), dst_mesh=(2, 2, 2),
                          arm="naive"),
            tp.CollectiveArm("allreduce-ring", 8 << 20, axis=2)]),
    }


# ------------------------------------------------------ edge models

EDGE_CASES = [
    ((8,), (4,)), ((8, 6), (2, 3)), ((6, 8), (1, 4)), ((4, 6, 8), (2, 1, 2)),
    ((3, 5, 7), (2, 2, 2)), ((5,), (1,)), ((12, 12), (3, 1)),
]


@pytest.mark.parametrize("local,mesh", EDGE_CASES)
@pytest.mark.parametrize("periodic", [False, True])
def test_halo_edges_equal_jax(local, mesh, periodic):
    for width in (1, 2):
        for parts in (None, 1, 3):
            if min(local) < width:
                continue
            got = ppatterns.halo_edges(local, mesh, periodic, 4, width,
                                       parts)
            want = jpatterns.halo_edges(local, mesh, periodic, 4, width,
                                        parts)
            assert [tuple(vars(e).values()) for e in got] == [
                tuple(vars(e).values()) for e in want]
            assert [e.is_wire for e in got] == [e.is_wire for e in want]
            assert ppatterns.wire_total(got) == jpatterns.wire_total(want)
        got = ppatterns.deep_halo_edges(local, mesh, periodic, 2, width)
        want = jpatterns.deep_halo_edges(local, mesh, periodic, 2, width)
        assert [tuple(vars(e).values()) for e in got] == [
            tuple(vars(e).values()) for e in want]


def test_edge_models_refuse_as_jax():
    for fn, args in [
        ("halo_edges", ((4, 4), (2,), False, 4)),
        ("halo_edges", ((1, 4), (2, 2), False, 4, 2)),
        ("deep_halo_edges", ((4, 4), (2, 2), False, 4, 0)),
        ("deep_halo_edges", ((4,), (2, 2), False, 4, 1)),
    ]:
        with pytest.raises(ValueError) as want:
            getattr(jpatterns, fn)(*args)
        with pytest.raises(ValueError) as got:
            getattr(ppatterns, fn)(*args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mesh", [(1,), (4,), (2, 3), (3, 1, 2)])
def test_rank_tables_and_ring_allgather_equal_jax(mesh):
    n = ppatterns._ranks(mesh)
    assert n == jpatterns._ranks(mesh) == math.prod(mesh)
    for r in range(n):
        c = ppatterns._coords(r, mesh)
        assert c == jpatterns._coords(r, mesh)
        assert ppatterns._rank(c, mesh) == jpatterns._rank(c, mesh) == r
    for block in (1, 4096):
        assert ppatterns.ring_allgather_edges(n, block) == [
            ppatterns.Edge(*vars(e).values())
            for e in jpatterns.ring_allgather_edges(n, block)]


RESHARD_PAIRS = [
    ((16, 8), (4, 1), (2, 2)), ((16, 8), (2, 2), (4, 1)),
    ((12, 6), (3, 2), (2, 3)), ((8, 8), (4, 2), (2, 1)),
    ((8, 12, 4), (2, 3, 1), (1, 2, 2)), ((6144, 768), (4, 3), (2, 6)),
]


@pytest.mark.parametrize("gshape,src,dst", RESHARD_PAIRS)
@pytest.mark.parametrize("arm", ["naive", "sequential"])
def test_reshard_edges_equal_jax(gshape, src, dst, arm):
    got = pcommaudit.reshard_edges(
        preshard.plan_reshard(gshape, src, dst, 4), arm)
    want = jcommaudit.reshard_edges(
        jreshard.plan_reshard(gshape, src, dst, 4), arm)
    assert [tuple(vars(e).values()) for e in got] == [
        tuple(vars(e).values()) for e in want]


def test_reshard_edges_refuse_an_unknown_arm_as_jax():
    plan = (16, 8), (4, 1), (2, 2), 4
    with pytest.raises(ValueError) as want:
        jcommaudit.reshard_edges(jreshard.plan_reshard(*plan), "ring")
    with pytest.raises(ValueError) as got:
        pcommaudit.reshard_edges(preshard.plan_reshard(*plan), "ring")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------ the search

@pytest.mark.parametrize("ndims", [1, 2, 3])
def test_enumerate_factorizations_equal_jax(ndims):
    for n in range(1, 25):
        assert ptp.enumerate_factorizations(n, ndims) == \
            jtp.enumerate_factorizations(n, ndims)
    for bad in ((0, ndims), (4, 0)):
        with pytest.raises(ValueError) as want:
            jtp.enumerate_factorizations(*bad)
        with pytest.raises(ValueError) as got:
            ptp.enumerate_factorizations(*bad)
        assert str(got.value) == str(want.value)


SPECS = [
    ("halo", "6144x768:w2:periodic:x200"), ("halo", "64x64:p4:f8:bfloat16"),
    ("halo", "64X32X16:int8:x0.5"), ("halo", "8192x64"),
    ("reshard", "6144x768:to2x6:sequential"),
    ("reshard", "6144x768:TO2x6:naive:float16:x3"),
    ("collective", "allreduce-ring:8m:axis1"), ("collective", "ppermute:64k"),
    ("collective", "bcast-tree:1.5g:x2"), ("collective", "allgather-ring:4096"),
]
BAD_SPECS = [
    ("halo", "64x64:zzz"), ("halo", "64xq"), ("halo", "64x64:w0"),
    ("halo", "64x0"), ("halo", "64x64:float64x"), ("reshard", "64x64:naive"),
    ("reshard", "64x64:to2x2x2"), ("reshard", "64x64:to2:ring"),
    ("collective", "ppermute"), ("collective", "no-such-op:8m"),
    ("collective", "ppermute:8q"), ("collective", "ppermute:8m:axisx"),
    ("collective", "ppermute:0"),
]


@pytest.mark.parametrize("kind,spec", SPECS)
def test_spec_parsers_round_trip_as_jax(kind, spec):
    got = getattr(ptp, f"parse_{kind}_spec")(spec)
    want = getattr(jtp, f"parse_{kind}_spec")(spec)
    assert got.to_dict() == want.to_dict()
    assert ptp.arm_from_dict(got.to_dict()) == got
    assert ptp.mix_to_dicts([got]) == jtp.mix_to_dicts([want])


@pytest.mark.parametrize("kind,spec", BAD_SPECS)
def test_spec_parsers_refuse_as_jax(kind, spec):
    with pytest.raises(ValueError) as want:
        getattr(jtp, f"parse_{kind}_spec")(spec)
    with pytest.raises(ValueError) as got:
        getattr(ptp, f"parse_{kind}_spec")(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("d", [
    {"kind": "halo", "gshape": [8, 8], "bogus": 1}, {"kind": "nope"},
    [1, 2], {"kind": "reshard", "gshape": [8], "dst_mesh": [2, 2]},
    {"kind": "collective", "op": "ppermute", "nbytes": 8, "weight": 0},
])
def test_arm_from_dict_refuses_as_jax(d):
    with pytest.raises(ValueError) as want:
        jtp.arm_from_dict(d)
    with pytest.raises(ValueError) as got:
        ptp.arm_from_dict(d)
    assert str(got.value) == str(want.value)


def _arm_pairs():
    """(port arm, JAX arm) pairs: each halo variant, each reshard arm,
    each collective op."""
    pairs = []
    for kw in ({"width": 1}, {"width": 2, "periodic": True},
               {"width": 1, "fuse_steps": 4}, {"width": 1, "parts": 3},
               {"width": 3, "dtype": "bfloat16", "weight": 7.5}):
        for gshape in ((96, 48), (48, 24, 12)):
            pairs.append((ptp.HaloArm(gshape=gshape, **kw),
                          jtp.HaloArm(gshape=gshape, **kw)))
    for arm in ("naive", "sequential"):
        for gshape, dst in (((96, 48), (4, 3)), ((48, 24, 12), (2, 3, 2))):
            pairs.append((ptp.ReshardArm(gshape, dst, arm),
                          jtp.ReshardArm(gshape, dst, arm)))
    for op in ptp.COLLECTIVE_OPS:
        for axis in (0, 1, 2):
            pairs.append((ptp.CollectiveArm(op, 3 << 20, axis),
                          jtp.CollectiveArm(op, 3 << 20, axis)))
    return pairs


@pytest.mark.parametrize("i", range(len(_arm_pairs())))
def test_score_mesh_equals_jax_on_every_candidate(i):
    parm, jarm = _arm_pairs()[i]
    assert parm.to_dict() == jarm.to_dict()
    ndims = len(getattr(parm, "gshape", (0, 0, 0)))
    for mesh in ptp.enumerate_factorizations(12, ndims):
        got = ptp.score_mesh([parm], mesh)
        want = jtp.score_mesh([jarm], mesh)
        assert got == want and type(got) is type(want), mesh


@pytest.mark.parametrize("mix", list(_mixes(ptp)))
def test_plan_entry_equals_jax_on_every_field(mix):
    n, ndims, parms = _mixes(ptp)[mix]
    _, _, jarms = _mixes(jtp)[mix]
    got = ptp.plan_entry(n, ndims, parms, date="2026-10-18")
    want = jtp.plan_entry(n, ndims, jarms, date="2026-10-18")
    assert got == want
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    # declaration order does not move the id
    assert ptp.plan_entry(n, ndims, list(reversed(parms)))["plan_id"] == \
        got["plan_id"]


@pytest.mark.parametrize("n,ndims,arms", [
    (8, 2, lambda tp: []),
    (7, 2, lambda tp: [tp.HaloArm((13, 13))]),
    (8, 2, lambda tp: [tp.HaloArm((8, 8, 8))]),
    (8, 2, lambda tp: [tp.CollectiveArm("ppermute", 8, axis=2)]),
    (8, 2, lambda tp: [tp.ReshardArm((8, 8), (2, 2))]),
], ids=["empty", "infeasible", "ndim", "axis", "dst"])
def test_plan_entry_refuses_as_jax(n, ndims, arms):
    with pytest.raises(ValueError) as want:
        jtp.plan_entry(n, ndims, arms(jtp))
    with pytest.raises(ValueError) as got:
        ptp.plan_entry(n, ndims, arms(ptp))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------ the artifact

def test_committed_artifact_recomputes_and_is_jaxs_banked_entries():
    doc = json.loads(ptp.PLAN_PATH.read_text())
    plans = doc["plans"]
    assert [(e["n_devices"], e["ndims"]) for e in plans] == [(12, 2),
                                                            (24, 2)]
    for e in plans:
        arms = [ptp.arm_from_dict(d) for d in e["mix"]]
        assert ptp.plan_entry(e["n_devices"], e["ndims"], arms,
                              date=e["date"]) == e
    jplans = json.loads(jtp.PLAN_PATH.read_text())["plans"]
    assert [{k: v for k, v in e.items() if k != "date"} for e in plans] \
        == [{k: v for k, v in e.items() if k != "date"} for e in jplans]
    assert [tuple(e["mesh"]) for e in plans] == [(2, 6), (24, 1)]
    assert [tuple(e["default_mesh"]) for e in plans] == [(4, 3), (6, 4)]
    assert doc["_meta"] == ptp._META
    assert ptp.PLAN_REL == "tpu_comm_torch/data/topo_plan.json"
    assert ptp.PLAN_PATH.as_posix().endswith(ptp.PLAN_REL)


@pytest.mark.parametrize("ndims", [1, 2, 3])
def test_committed_artifact_answers_no_tier1_or_card_mesh(ndims):
    for n in (1, 4, 8):
        assert ptp.lookup(n, ndims) is None
    assert (ptp.lookup(12, ndims) is None) == (ndims != 2)


def test_artifact_round_trip_upsert_and_lookup_as_jax(tmp_path):
    mixes_p, mixes_j = _mixes(ptp), _mixes(jtp)
    ppath, jpath = tmp_path / "p.json", tmp_path / "j.json"
    assert ptp.load_plans(ppath) == {"_meta": ptp._META, "plans": []}
    assert ptp.lookup(12, 2, path=ppath) is None
    for name in ("banked12", "skewed8", "ppermute8", "banked12"):
        n, ndims, arms = mixes_p[name]
        ptp.save_plan(ptp.plan_entry(n, ndims, arms, date="d"), ppath)
        n, ndims, arms = mixes_j[name]
        jtp.save_plan(jtp.plan_entry(n, ndims, arms, date="d"), jpath)
    pdoc, jdoc = (json.loads(p.read_text()) for p in (ppath, jpath))
    assert pdoc["plans"] == jdoc["plans"]
    assert [(e["n_devices"], e["ndims"]) for e in pdoc["plans"]] == [
        (8, 1), (8, 2), (12, 2)]
    for key in ((8, 1), (8, 2), (12, 2), (8, 3), (4, 2)):
        assert ptp.lookup(*key, path=ppath) == jtp.lookup(*key, path=jpath)
    # a bad artifact: lookup answers None, load_plans raises, save_plan
    # starts it over
    ppath.write_text('{"plans": 3}')
    assert ptp.lookup(12, 2, path=ppath) is None
    with pytest.raises(ValueError, match="top-level 'plans' list"):
        ptp.load_plans(ppath)
    n, ndims, arms = mixes_p["skewed8"]
    ptp.save_plan(ptp.plan_entry(n, ndims, arms), ppath)
    assert [e["n_devices"] for e in ptp.load_plans(ppath)["plans"]] == [8]


def _doc(*entries):
    return {"plans": list(entries)}


@pytest.mark.parametrize("knob", [None, "1", "path", "0", "off", "none",
                                  " OFF "])
def test_planned_mesh_shape_knob_states_equal_jax(knob, tmp_path,
                                                  monkeypatch):
    n, ndims, arms = _mixes(ptp)["skewed8"]
    entry = ptp.plan_entry(n, ndims, arms)
    art = tmp_path / "topo_plan.json"
    art.write_text(json.dumps(_doc(entry)))
    if knob is None:
        monkeypatch.delenv("TPU_COMM_TOPO_PLAN", raising=False)
    else:
        monkeypatch.setenv("TPU_COMM_TOPO_PLAN",
                           str(art) if knob == "path" else knob)
    for key in ((8, 2), (12, 2), (24, 2), (8, 1), (1, 1)):
        got = ptopo.planned_mesh_shape(*key)
        assert got == jtopo.planned_mesh_shape(*key), key
    want = {None: (2, 6), "1": (2, 6), "path": None}.get(knob)
    assert ptopo.planned_mesh_shape(12, 2)[0] == want
    if knob == "path":
        assert ptopo.planned_mesh_shape(8, 2) == ((8, 1), entry["plan_id"])


def test_a_plan_that_does_not_multiply_out_is_ignored_as_jax(tmp_path,
                                                             monkeypatch):
    n, ndims, arms = _mixes(ptp)["skewed8"]
    bad = dict(ptp.plan_entry(n, ndims, arms), mesh=[4, 4])
    short = dict(ptp.plan_entry(n, ndims, arms), mesh=[8])
    for entry in (bad, short):
        art = tmp_path / f"{len(entry['mesh'])}.json"
        art.write_text(json.dumps(_doc(entry)))
        monkeypatch.setenv("TPU_COMM_TOPO_PLAN", str(art))
        assert ptopo.planned_mesh_shape(8, 2) == (None, None)
        assert jtopo.planned_mesh_shape(8, 2) == (None, None)


def test_make_cart_mesh_stamps_the_plan_and_a_shape_wins(tmp_path,
                                                          monkeypatch):
    n, ndims, arms = _mixes(ptp)["skewed8"]
    entry = ptp.plan_entry(n, ndims, arms)
    art = tmp_path / "topo_plan.json"
    art.write_text(json.dumps(_doc(entry)))
    monkeypatch.setenv("TPU_COMM_TOPO_PLAN", str(art))
    cart = ptopo.make_cart_mesh(2, world=8, rank=5)
    assert (cart.shape, cart.plan_id, cart.coords) == (
        (8, 1), entry["plan_id"], (5, 0))
    cart = ptopo.make_cart_mesh(2, shape=(2, 4), world=8, rank=5)
    assert (cart.shape, cart.plan_id) == ((2, 4), None)
    cart = ptopo.make_cart_mesh(3, world=8, rank=5)  # no (8, 3) plan
    assert (cart.shape, cart.plan_id) == ((2, 2, 2), None)
    monkeypatch.setenv("TPU_COMM_TOPO_PLAN", "0")
    cart = ptopo.make_cart_mesh(2, world=8, rank=5)
    assert (cart.shape, cart.plan_id) == ((4, 2), None)
    # the lookup reads a rewritten artifact (its cache is by mtime)
    monkeypatch.setenv("TPU_COMM_TOPO_PLAN", str(art))
    other = ptp.plan_entry(8, 2, [ptp.HaloArm(gshape=(64, 8192), width=2,
                                              periodic=True)])
    ptp.save_plan(other, art)
    cart = ptopo.make_cart_mesh(2, world=8, rank=5)
    assert (cart.shape, cart.plan_id) == ((1, 8), other["plan_id"])


# ------------------------------------------------------ the command line

def _cli_out(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("i", range(len(BANKED_ARGV)))
@pytest.mark.parametrize("json_flag", [True, False], ids=["json", "text"])
def test_cli_topo_plan_dry_run_equals_jax(i, json_flag, capsys):
    argv = ["topo", "plan", *BANKED_ARGV[i], "--dry-run",
            *(["--json"] if json_flag else [])]
    rc, out, err = _cli_out(cli.main, argv, capsys)
    jrc, jout, jerr = _cli_out(jcli.main, argv, capsys)
    assert rc == jrc == 0 and err == jerr == ""
    if json_flag:
        got, want = json.loads(out), json.loads(jout)
        assert got.pop("date") and want.pop("date")
        assert got == want
        assert got == {k: v for k, v in json.loads(
            ptp.PLAN_PATH.read_text())["plans"][i].items() if k != "date"}
    else:
        assert out == jout


@pytest.mark.parametrize("argv", [
    ["--n-devices", "12", "--halo", "6144x768:zzz"],
    ["--n-devices", "12"],
    ["--n-devices", "7", "--halo", "13x13"],
    ["--n-devices", "4", "--collective", "ppermute:1m:axis3"],
])
def test_cli_topo_plan_refusals_equal_jax(argv, tmp_path, capsys):
    out = tmp_path / "plan.json"
    full = ["topo", "plan", *argv, "--out", str(out)]
    rc, stdout, err = _cli_out(cli.main, full, capsys)
    jrc, jstdout, jerr = _cli_out(jcli.main, full, capsys)
    assert rc == jrc == 2 and stdout == jstdout == ""
    assert err == jerr and err.startswith("error: ")
    assert not out.exists()


def test_cli_topo_plan_banks_into_out_as_jax(tmp_path, capsys):
    argv = ["topo", "plan", "--n-devices", "8", "--halo",
            "8192x64:w2:periodic"]
    rc, out, err = _cli_out(
        cli.main, [*argv, "--out", str(tmp_path / "p.json")], capsys)
    jrc, jout, jerr = _cli_out(
        jcli.main, [*argv, "--out", str(tmp_path / "j.json")], capsys)
    assert rc == jrc == 0 and out == jout
    assert err == jerr.replace("j.json", "p.json")
    pdoc, jdoc = (json.loads((tmp_path / f).read_text())
                  for f in ("p.json", "j.json"))
    assert pdoc["plans"] == jdoc["plans"]
    assert ptp.lookup(8, 2, path=tmp_path / "p.json")["mesh"] == [8, 1]
    with pytest.raises(SystemExit):
        cli.main(["topo"])
