"""``comm_compression`` in the port held against the JAX package: the
config schema and its ``validate`` errors, ``policy_for`` over a grid of
op x axis x bytes x enabled, ``local_members``,
``hierarchical_axis_groups``, and every quantized and coalesced
collective on 2 and 4 gloo ranks against the JAX one under a compiled
``shard_map`` on a mesh of as many CPU devices, with the same per-member
numpy inputs.

The codec output and every exchange that sums nothing (gathers, the
broadcast, the all-to-all) are bitwise the JAX package's; the
reduce-scatters and the all-reduce dequantize and sum f32 rows, which
XLA may contract into fused multiply-adds: the reduce-scatters are held
to 1e-6 relative plus 1e-6 absolute (the inputs are of order 1: 1e-6
relative to the largest addend), which they meet; the all-reduce
quantizes that sum again for its gather leg, so where the two sums part
by an ulp across a rounding boundary its outputs part by one step of the
block (at most 2% of the elements; the test counts them). A coalesced form is bitwise the per-leaf forms of the
port. Each call's accounted wire bytes (and their inter-host part) equal
the JAX package's, which accounts the same models at trace time."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # pre-0.5 spelling
    from jax.experimental.shard_map import shard_map

import deepspeed_tpu.comm as jdist
from deepspeed_tpu.comm import compression as jcomp
from deepspeed_tpu.parallel.topology import hierarchical_axis_groups as jhag
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.runtime.config_utils import ConfigError as JConfigError
from deepspeed_tpu_torch.comm import compression as tcomp
from deepspeed_tpu_torch.parallel.topology import \
    hierarchical_axis_groups as thag
from deepspeed_tpu_torch.runtime.config_utils import ConfigError

import torch_dist_worker
import torch_quant_worker

RTOL, ATOL = 1e-6, 1e-6


# ------------------------------------------------------------------ config

BAD = [{"policy": "int8"}, {"all_gather": "int4"}, {"block_size": 0},
       {"devices_per_host": -1}, {"min_bytes": -5},
       {"enabled": True, "reduce_scatter": "fp16"}]


@pytest.mark.parametrize("block", BAD)
def test_config_errors_are_the_jax_errors(block):
    with pytest.raises(JConfigError) as jerr:
        jcomp.CommCompressionConfig.from_dict(block)
    with pytest.raises(ConfigError) as terr:
        tcomp.CommCompressionConfig.from_dict(block)
    assert str(terr.value).replace("deepspeed_tpu_torch", "deepspeed_tpu") \
        == str(jerr.value)


def test_config_fields_and_defaults_are_the_jax_ones():
    jf = {f.name: f.default for f in dataclasses.fields(
        jcomp.CommCompressionConfig) if f.name != "_ALIASES"}
    tf = {f.name: f.default for f in dataclasses.fields(
        tcomp.CommCompressionConfig) if f.name != "_ALIASES"}
    assert tf == jf
    assert tcomp.COMPRESSIBLE_OPS == jcomp.COMPRESSIBLE_OPS
    assert tcomp.POLICIES == jcomp.POLICIES


def test_configure_returns_the_installed_config():
    cfg = tcomp.configure_comm_compression(
        {"enabled": True, "all_gather": "int8"})
    try:
        assert isinstance(cfg, tcomp.CommCompressionConfig)
        assert tcomp.get_comm_compression() is cfg
        assert cfg.policy_for("all_gather", "data", 1 << 20) == "int8"
        off = tcomp.configure_comm_compression(
            {"enabled": False, "all_gather": "int8"})
        assert off.policy_for("all_gather", "data", 1 << 20) == "off"
        assert not off.zero_path_active
    finally:
        tcomp.reset_comm_compression()
    assert tcomp.get_comm_compression().enabled is False


POLICY_SETS = [
    {"enabled": True, "all_gather": "int8", "reduce_scatter": "fp8_block",
     "all_reduce": "fp32", "all_to_all": "int8", "broadcast": "off"},
    {"enabled": False, "all_gather": "int8", "reduce_scatter": "int8"},
    {"enabled": True, "all_reduce": "int8", "min_bytes": 0,
     "allowed_axes": ["data"]},
]


@pytest.mark.parametrize("i", range(len(POLICY_SETS)))
def test_policy_for_over_the_grid(i):
    j = jcomp.CommCompressionConfig.from_dict(POLICY_SETS[i])
    t = tcomp.CommCompressionConfig.from_dict(POLICY_SETS[i])
    n = 0
    for op in jcomp.COMPRESSIBLE_OPS + ("ppermute",):
        for axis in ("data", "model", "expert", ("data", "expert"),
                     ("data", "model"), ["data"]):
            for nbytes in (0, 2047, 2048, 1 << 20):
                assert t.policy_for(op, axis, nbytes) == \
                    j.policy_for(op, axis, nbytes), (op, axis, nbytes)
                n += 1
    assert t.zero_path_active == j.zero_path_active
    assert n == 6 * 6 * 4


def test_local_members_and_axis_groups(monkeypatch):
    """``devices_per_host`` 0 reads the launcher's ``LOCAL_WORLD_SIZE`` in
    the port where the JAX package reads its local device count (8 in
    these tests)."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(jax.local_device_count()))
    for dph in (0, 1, 2, 3, 4, 8):
        j = jcomp.CommCompressionConfig(devices_per_host=dph)
        t = tcomp.CommCompressionConfig(devices_per_host=dph)
        for size in (1, 2, 4, 6, 8, 16):
            assert t.local_members(size) == j.local_members(size)
            assert thag(size, dph) == jhag(size, dph)
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert tcomp.CommCompressionConfig().local_members(8) == 0


def test_data_host_groups_of_the_mesh(monkeypatch):
    from deepspeed_tpu_torch.parallel.topology import DeviceMeshManager
    mm = DeviceMeshManager(dp=8, world_size=8, rank=0)
    assert mm.data_host_groups(2) == jhag(8, 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert mm.data_host_groups() == jhag(8, 4)


# ------------------------------------------------------------- collectives

BLOCK = 64


def _cc(**over):
    cfg = {"enabled": True, "all_gather": "int8", "reduce_scatter": "int8",
           "all_reduce": "int8", "all_to_all": "int8", "broadcast": "int8",
           "min_bytes": 0, "block_size": BLOCK, "devices_per_host": 0}
    cfg.update(over)
    return cfg


def _inputs(n, shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(n)]


def _calls(n):
    """``(label, op, policy, per-rank inputs, port kwargs, JAX fn of one
    member's inputs)``."""
    A = jdist.ReduceOp.AVG
    out = []
    for wire in ("int8", "fp8_block"):
        xs = _inputs(n, (4, 96), 1)              # 384 values: blocks divide
        out.append((f"ag0-{wire}", "all_gather", _cc(all_gather=wire), xs,
                    {"axis_name": "data", "axis": 0},
                    lambda v: jdist.all_gather(v, "data", axis=0)))
        ys = _inputs(n, (3, 10), 2)              # 30 values: one block
        out.append((f"ag1-{wire}", "all_gather", _cc(all_gather=wire), ys,
                    {"axis_name": "data", "axis": 1},
                    lambda v: jdist.all_gather(v, "data", axis=1)))
        zs = _inputs(n, (8 * n, 48), 3)
        out.append((f"rs0-{wire}", "reduce_scatter",
                    _cc(reduce_scatter=wire), zs,
                    {"axis_name": "data", "axis": 0},
                    lambda v: jdist.reduce_scatter(v, "data", axis=0)))
        ws = _inputs(n, (6, 4 * n), 4)
        out.append((f"rs1avg-{wire}", "reduce_scatter",
                    _cc(reduce_scatter=wire), ws,
                    {"axis_name": "data", "axis": 1, "op": "avg"},
                    lambda v: jdist.reduce_scatter(v, "data", axis=1, op=A)))
        out.append((f"ar-{wire}", "all_reduce", _cc(all_reduce=wire),
                    _inputs(n, (16, 8 * n), 5),
                    {"axis_name": "data", "op": "avg"},
                    lambda v: jdist.all_reduce(v, op=A, axis_name="data")))
        out.append((f"a2a-{wire}", "all_to_all", _cc(all_to_all=wire),
                    _inputs(n, (4 * n, 2 * n, 8), 6),
                    {"axis_name": "data", "split_axis": 1, "concat_axis": 0},
                    lambda v: jdist.all_to_all(v, "data", split_axis=1,
                                               concat_axis=0)))
        out.append((f"bc-{wire}", "broadcast", _cc(broadcast=wire),
                    _inputs(n, (5, 64), 7),
                    {"axis_name": "data", "src": n - 1},
                    lambda v: jdist.broadcast(v, src=n - 1,
                                              axis_name="data")))
        bucket = [_inputs(n, (4, 96), 8), _inputs(n, (3, 10), 9),
                  _inputs(n, (2 * n, 7), 10)]
        per_rank = [[b[r] for b in bucket] for r in range(n)]
        out.append((f"agc-{wire}", "all_gather_coalesced",
                    _cc(all_gather=wire), per_rank,
                    {"axis_name": "data", "axes": [0, 1, 0]},
                    lambda *v: tuple(jdist.all_gather_coalesced(
                        list(v), "data", axes=[0, 1, 0]))))
        rbucket = [_inputs(n, (8 * n, 48), 11), _inputs(n, (6, 4 * n), 12),
                   _inputs(n, (2 * n, 3), 13)]
        per_rank = [[b[r] for b in rbucket] for r in range(n)]
        out.append((f"rsc-{wire}", "reduce_scatter_coalesced",
                    _cc(reduce_scatter=wire), per_rank,
                    {"axis_name": "data", "axes": [0, 1, 0], "op": "avg"},
                    lambda *v: tuple(jdist.reduce_scatter_coalesced(
                        list(v), "data", axes=[0, 1, 0], op=A))))
        if n == 4:
            hier = _cc(reduce_scatter=wire, devices_per_host=2)
            out.append((f"rsh-{wire}", "reduce_scatter", hier, zs,
                        {"axis_name": "data", "axis": 0, "op": "avg"},
                        lambda v: jdist.reduce_scatter(v, "data", axis=0,
                                                       op=A)))
            out.append((f"rshc-{wire}", "reduce_scatter_coalesced", hier,
                        per_rank,
                        {"axis_name": "data", "axes": [0, 1, 0]},
                        lambda *v: tuple(jdist.reduce_scatter_coalesced(
                            list(v), "data", axes=[0, 1, 0]))))
    # below min_bytes: full precision through the dispatch (policy fp32)
    out.append(("ag-min-bytes", "all_gather", _cc(min_bytes=1 << 20),
                _inputs(n, (4, 96), 14), {"axis_name": "data", "axis": 0},
                lambda v: jdist.all_gather(v, "data", axis=0)))
    return out


def _jax_call(n, cc, inputs, fn):
    """The JAX collective under ``shard_map`` over ``n`` CPU devices: each
    member's output, and the wire bytes accounted at trace time."""
    jcomp.configure_comm_compression(cc)
    mesh = initialize_mesh(dp=n, devices=jax.devices("cpu")[:n]).mesh
    many = isinstance(inputs[0], list)
    stacked = [jnp.asarray(np.stack([r[k] for r in inputs]))
               for k in range(len(inputs[0]))] if many else \
        [jnp.asarray(np.stack(inputs))]

    def body(*vs):
        outs = fn(*[v[0] for v in vs])
        return jax.tree.map(lambda o: o[None], outs)

    specs = tuple(P("data") for _ in stacked)
    try:
        f = shard_map(body, mesh=mesh, in_specs=specs, out_specs=P("data"),
                      check_vma=False)
    except TypeError:
        f = shard_map(body, mesh=mesh, in_specs=specs, out_specs=P("data"),
                      check_rep=False)
    f = jax.jit(f)      # compiled, as the JAX package runs its collectives
    jdist.reset_comm_stats()
    out = jax.tree.map(np.asarray, f(*stacked))
    stats = dict(jdist.comm_stats())
    jcomp.reset_comm_compression()
    return out, stats


def _chunk_steps(w, n, wire):
    """One codec step of each element's block in the all-reduce's gather
    leg (the reduced chunk, blocks of ``BLOCK`` or one a chunk)."""
    chunk = w.reshape(n, -1)
    c = chunk.shape[1]
    eff = BLOCK if c % BLOCK == 0 else c
    div = 127.0 if wire == "int8" else 448.0 / 32.0
    am = np.abs(chunk.reshape(n, c // eff, eff)).max(-1) / div
    return np.repeat(am, eff, axis=1).reshape(w.shape)


_WORLDS = {}


def _world(n, tmp_path_factory):
    """The ``n``-rank results (made once a module): the calls, the JAX
    package's outputs and stats, and each rank's."""
    if n in _WORLDS:
        return _WORLDS[n]
    calls = _calls(n)
    payload = {"calls": [(op, cc, ins, dict(kw)) for _, op, cc, ins, kw, _
                         in calls]}
    # the per-leaf forms of each coalesced bucket, for the bitwise check
    for label, op, cc, ins, kw, _ in calls:
        if op.endswith("_coalesced"):
            single = op[:-len("_coalesced")]
            for k, axis in enumerate(kw["axes"]):
                one = {"axis_name": "data", "axis": axis}
                if "op" in kw:
                    one["op"] = kw["op"]
                payload["calls"].append((single, cc, [r[k] for r in ins],
                                         one))
    started = torch_dist_worker.start(torch_quant_worker.collective_cases, n,
                                      tmp_path_factory.mktemp(f"cc{n}"),
                                      payload)
    want = [_jax_call(n, cc, ins, fn) for _, _, cc, ins, _, fn in calls]
    ranks = torch_dist_worker.join(started)
    _WORLDS[n] = (n, calls, want, ranks)
    return _WORLDS[n]


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    return _world(request.param, tmp_path_factory)


CASES = [(n, c[0]) for n in (2, 4) for c in _calls(n)]


@pytest.mark.parametrize("n,label", CASES)
def test_collective_matches_the_jax_one(tmp_path_factory, n, label):
    n, calls, want, ranks = _world(n, tmp_path_factory)
    labels = [c[0] for c in calls]
    i = labels.index(label)
    op = calls[i][1]
    jout, jstats = want[i]
    exact = not ("reduce_scatter" in op or op == "all_reduce")
    for r in range(n):
        got = ranks[r][i]["result"]
        wants = [o[r] for o in jout] if isinstance(jout, tuple) else \
            [jout[r]]
        gots = got if isinstance(got, list) else [got]
        for g, w in zip(gots, wants):
            assert g.shape == w.shape
            if exact:
                np.testing.assert_array_equal(g.view(np.uint32),
                                              w.view(np.uint32))
            elif op == "all_reduce":
                # the gather leg re-quantizes the reduced chunk: where the
                # packages' sums part by an ulp across a rounding boundary,
                # they part by one step of the chunk's block
                step = _chunk_steps(w, n, calls[i][2]["all_reduce"])
                off = np.abs(g - w) > ATOL + RTOL * np.abs(w)
                assert (np.abs(g - w) <= step * 1.0001 + ATOL).all()
                assert off.mean() <= 0.02, off.mean()
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        # per-call wire bytes: the JAX models, split as the JAX split
        assert ranks[r][i]["bytes"] == jstats["bytes"], label
        assert ranks[r][i]["inter"] == jstats["inter_host_bytes"], label
        assert ranks[r][i]["logical"] == jstats["logical_bytes"], label
        assert ranks[r][i]["ops"] == 1


def test_coalesced_forms_are_bitwise_the_per_leaf_forms(world):
    n, calls, _, ranks = world
    extra = len(calls)
    for i, (label, op, _, _, kw, _) in enumerate(calls):
        if not op.endswith("_coalesced"):
            continue
        for r in range(n):
            per_leaf = [ranks[r][extra + k]["result"]
                        for k in range(len(kw["axes"]))]
            for a, b in zip(ranks[r][i]["result"], per_leaf):
                np.testing.assert_array_equal(a.view(np.uint32),
                                              b.view(np.uint32))
            # one op, the bytes of the per-leaf models summed
            assert ranks[r][i]["bytes"] == sum(
                ranks[r][extra + k]["bytes"] for k in range(len(kw["axes"])))
        extra += len(kw["axes"])


def test_int8_wire_ratio_is_the_model(world):
    """int8 over fp32 payloads at block 64: (1 + 4/64) / 4 of the bytes
    for the all-gather (the flat reduce-scatter too, rows divide)."""
    n, calls, want, ranks = world
    labels = [c[0] for c in calls]
    q = ranks[0][labels.index("ag0-int8")]["bytes"]
    f = ranks[0][labels.index("ag-min-bytes")]["bytes"]
    assert q / f == pytest.approx((1 + 4 / BLOCK) / 4, rel=1e-12)
