"""The explicit (compressed) ZeRO exchange of the port on gloo ranks held
against the JAX package's engine on a dp mesh of CPU devices, under
``comm_compression``: tiny GPT-2 and LLaMA (``torch_zero_pairs``, width
64, 2 layers, f32) at stages 1, 2 and 3 with the policies ``fp32``,
``int8`` and ``fp8_block`` at dp 2 (block 64, ``min_bytes`` 0), and the
hierarchical exchange at dp 4 with 2 devices a host.

- One micro step's gradients (forward + backward on the first micro
  batch): under ``fp32`` within the f32 tolerance of the ZeRO parity
  tests (atol 2e-5, rtol 1e-4); under a quantized policy each element
  within one quantization step of its block plus that tolerance. The step
  is computed from the ranks' own unreduced gradients: for a
  reduce-scattered leaf the sum over the ranks of the scale of the block
  that carries the element (absmax / 127 for int8; absmax / 14, one e4m3
  step at the top of its range, for fp8), divided by dp, and for an
  all-reduced leaf that plus the reduced chunk's block step; for the
  hierarchical exchange the host sums' steps, from the largest block of
  the leaf. The tests count the elements that differ at all beyond the
  f32 tolerance (a rounding that crossed a half-step in one package and
  not in the other).
- Losses and masters after 3 steps: fp32 within the parity tolerance;
  quantized runs within ``QLOSS_RTOL`` (losses) and ``QMASTER_ATOL``
  (masters: 5 lr a step, 3 steps at lr 1e-4: where a gradient element
  lands on the other side of a rounding boundary in one package, AdamW's
  normalized step of it can differ by more than 2 lr once its sign
  history differs).
- ``-100`` labels spread unevenly over the ranks and dropout 0.1: the
  explicit exchange takes each rank's own mean and keys the masks
  ``fold_in(rng, dp index)`` from row 0 of its rows; the fp32 gradients
  of those cases hold at the f32 tolerance, which they could not with
  other rows' masks or the global-share weighting.
- The scope error at tp 2 is the JAX package's text.
"""

import numpy as np
import pytest

import jax

import deepspeed_tpu
from deepspeed_tpu.comm.compression import reset_comm_compression
from deepspeed_tpu.parallel.topology import initialize_mesh

import torch_dist_worker
import torch_pairs
import torch_quant_worker
import torch_zero_pairs as zp

BLOCK = 64
STEP_DIV = {"int8": 127.0, "fp8_block": 448.0 / 32.0}
QLOSS_RTOL = 2e-3
QMASTER_ATOL = 5 * 1e-4 * zp.STEPS


def cc(policy, **extra):
    return dict({"enabled": True, "all_gather": policy,
                 "reduce_scatter": policy, "all_reduce": policy,
                 "block_size": BLOCK, "min_bytes": 0}, **extra)


def batches(n, dp, seed, labels=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, torch_pairs.VOCAB,
                           (zp.GAS, zp.MICRO * dp, zp.T)).astype(np.int32)
        b = {"input_ids": ids}
        if labels:          # uneven valid counts over the ranks
            lab = ids.copy()
            lab[:, 0, :5] = -100
            lab[:, zp.MICRO:, :20] = -100
            b["labels"] = lab
        out.append(b)
    return out


def jax_case(family, stage, policy, dp, seed, labels=False, extra=None,
             **over):
    """The JAX engine's first micro step's gradients, its step records
    and state, and the ranks' case."""
    cfg = zp.config(stage, comm_compression=cc(policy, **(extra or {})))
    cfg["train_batch_size"] = zp.MICRO * zp.GAS * dp
    kw, jcfg, jcls = torch_pairs.FAMILIES[family][:3]
    kw = {k: v for k, v in dict(kw, **over).items() if k != "dtype"}
    engine = deepspeed_tpu.initialize(
        model=jcls(jcfg(**dict(kw, attn_backend="xla"))), config=cfg,
        mesh_manager=initialize_mesh(dp=dp, devices=jax.devices("cpu")[:dp])
    )[0]
    tree = jax.tree.map(np.asarray, engine.params)
    data = batches(zp.STEPS, dp, seed, labels)
    engine.forward({k: v[0] for k, v in data[0].items()})
    g = jax.tree.map(np.asarray, engine._pending_grads)
    grads = {**{k: v for k, v in g.items() if k != "blocks"},
             **{f"blocks/{k}": v for k, v in g["blocks"].items()}}
    engine._pending_grads = None
    want = (zp.jax_run(engine, data), zp.jax_state(engine))
    reset_comm_compression()
    return grads, want, {"family": family, "kw": kw, "tree": tree,
                         "config": cfg, "batches": data}


# (family, stage, policy, extra model kwargs, labels)
DP2 = [(f, s, p) for f in ("gpt2", "llama") for s in (1, 2, 3)
       for p in ("fp32", "int8", "fp8_block")]
DP2_EXTRA = [("gpt2", 2, "fp32", "labels"), ("gpt2", 3, "fp32", "dropout")]
DP4 = [("gpt2", 2, "int8"), ("llama", 3, "int8")]


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    wants, cases = [], []
    for i, (family, stage, policy) in enumerate(DP2):
        grads, want, c = jax_case(family, stage, policy, 2, seed=i)
        wants.append((grads, want))
        cases.append(c)
    for i, (family, stage, policy, what) in enumerate(DP2_EXTRA):
        over = {"dropout": 0.1} if what == "dropout" else {}
        grads, want, c = jax_case(family, stage, policy, 2, seed=50 + i,
                                  labels=what == "labels", **over)
        wants.append((grads, want))
        cases.append(c)
    ranks = torch_dist_worker.spawn(torch_quant_worker.compressed_cases, 2,
                                    tmp_path_factory.mktemp("cc2"),
                                    {"cases": cases}, timeout=600)
    return wants, ranks


@pytest.fixture(scope="module")
def dp4(tmp_path_factory):
    wants, cases = [], []
    for i, (family, stage, policy) in enumerate(DP4):
        grads, want, c = jax_case(family, stage, policy, 4, seed=70 + i,
                                  extra={"devices_per_host": 2})
        wants.append((grads, want))
        cases.append(c)
    # at dp 2 x tp 2 the explicit exchange is asked for and refused
    scope = dict(cases[0], config=dict(
        cases[0]["config"], train_batch_size=zp.MICRO * zp.GAS * 2,
        tensor_parallel_size=2))
    ranks = torch_dist_worker.spawn(torch_quant_worker.compressed_cases, 4,
                                    tmp_path_factory.mktemp("cc4"),
                                    {"cases": cases, "tp_scope": scope},
                                    timeout=600)
    return wants, ranks


def _block_steps(rows, block, div):
    """``[n, row]`` -> each element's block step (absmax of its block /
    div), blocks aligned to rows (one a row when ``block`` does not divide
    it)."""
    n, row = rows.shape
    eff = block if row % block == 0 else row
    s = np.abs(rows.reshape(n, row // eff, eff)).max(-1) / div
    return np.repeat(s, eff, axis=1)


def _rs_bound(locals_, dim, block, div):
    """One step of each rank's block carrying an element, averaged (the
    flat quantized reduce-scatter's rounding of the unreduced rows)."""
    n = len(locals_)
    total = 0.0
    moved = np.moveaxis(locals_[0], dim, 0).shape
    for g in locals_:
        total = total + _block_steps(np.moveaxis(g, dim, 0).reshape(n, -1),
                                     block, div)
    return np.moveaxis((total / n).reshape(moved), 0, dim)


def _ar_bound(locals_, reduced, block, div):
    """The quantized all-reduce: its reduce-scatter's steps, plus the step
    of the reduced chunk's block in the gather leg."""
    n = len(locals_)
    flat = [g.reshape(-1) for g in locals_]
    rs = _rs_bound(flat, 0, block, div)
    chunk = reduced.reshape(n, -1)
    c = chunk.shape[1]
    eff = block if c % block == 0 else c
    ag = np.repeat(np.abs(chunk.reshape(n, c // eff, eff)).max(-1) / div,
                   eff, axis=1).reshape(-1)
    return (rs + ag).reshape(reduced.shape)


def _hier_bound(locals_, local, div):
    """The hierarchical exchange quantizes the host sums: their largest
    block's step, summed over the hosts, averaged."""
    n = len(locals_)
    hosts = [sum(locals_[h * local:(h + 1) * local])
             for h in range(n // local)]
    return sum(np.abs(h).max() / div for h in hosts) / n


def _check_grads(got, want, local, policy, hier=0):
    """Every leaf within its bound; returns the count of elements past
    the f32 tolerance."""
    differ = 0
    for name, w in want.items():
        g = got[name]
        tol = zp.ATOL + zp.RTOL * np.abs(w)
        if policy in STEP_DIV:
            kind, dim, _ = local[0][name]
            ins = [r[name][2] for r in local]
            div = STEP_DIV[policy]
            if hier:
                bound = _hier_bound(ins, hier, div) if kind == "rs" else \
                    _ar_bound(ins, w, BLOCK, div)
            elif kind == "rs":
                bound = _rs_bound(ins, dim, BLOCK, div)
            else:
                bound = _ar_bound(ins, w, BLOCK, div)
            tol = tol + bound
        err = np.abs(g - w)
        assert (err <= tol).all(), (name, float(err.max()),
                                    float(np.max(tol)))
        differ += int((err > zp.ATOL + zp.RTOL * np.abs(w)).sum())
    return differ


def _check_run(ranks, i, want, policy):
    steps, state = want
    for r in ranks:
        for g, w in zip(r[i]["steps"], steps):
            rtol = zp.LOSS_RTOL if policy == "fp32" else QLOSS_RTOL
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=rtol)
    got = ranks[0][i]["state"]
    atol = zp.ATOL if policy == "fp32" else QMASTER_ATOL
    for path, value in state["params"].items():
        np.testing.assert_allclose(got["params"][path], value, atol=atol,
                                   rtol=zp.RTOL, err_msg=path)


@pytest.mark.parametrize("family,stage,policy", DP2)
def test_micro_step_gradients_match_the_jax_engine(dp2, family, stage,
                                                   policy):
    wants, ranks = dp2
    i = DP2.index((family, stage, policy))
    assert all(r[i]["explicit"] for r in ranks)
    differ = _check_grads(ranks[0][i]["grads"], wants[i][0],
                          ranks[0][i]["local"], policy)
    if policy == "fp32":
        assert differ == 0
    print(f"{family} stage {stage} {policy}: {differ} elements past the "
          f"f32 tolerance")


@pytest.mark.parametrize("family,stage,policy", DP2)
def test_losses_and_masters_after_three_steps(dp2, family, stage, policy):
    wants, ranks = dp2
    i = DP2.index((family, stage, policy))
    _check_run(ranks, i, wants[i][1], policy)


@pytest.mark.parametrize("what", ["labels", "dropout"])
def test_uneven_labels_and_dropout_follow_the_explicit_path(dp2, what):
    wants, ranks = dp2
    i = len(DP2) + [e[3] for e in DP2_EXTRA].index(what)
    assert _check_grads(ranks[0][i]["grads"], wants[i][0],
                        ranks[0][i]["local"], "fp32") == 0
    _check_run(ranks, i, wants[i][1], "fp32")


@pytest.mark.parametrize("family,stage,policy", DP4)
def test_hierarchical_exchange_at_dp4(dp4, family, stage, policy):
    wants, ranks = dp4
    i = DP4.index((family, stage, policy))
    differ = _check_grads(ranks[0][i]["grads"], wants[i][0],
                          ranks[0][i]["local"], policy, hier=2)
    print(f"dp4 {family} stage {stage}: {differ} elements past the f32 "
          f"tolerance")
    _check_run(ranks, i, wants[i][1], policy)
    # the inter-host bytes are the hierarchical reduce-scatters' second
    # legs: under half the wire at 2 of 4 members a host
    st = ranks[0][i]["stats"]
    assert 0 < st["inter_host_bytes"] < st["bytes"]


def test_compressed_wire_is_smaller_than_fp32(dp2):
    """The same steps move fewer wire bytes under int8 than under fp32."""
    _, ranks = dp2
    for family in ("gpt2", "llama"):
        for stage in (1, 2, 3):
            f = ranks[0][DP2.index((family, stage, "fp32"))]["stats"]
            q = ranks[0][DP2.index((family, stage, "int8"))]["stats"]
            assert q["bytes"] < f["bytes"] and q["ops"] == f["ops"]


def test_scope_error_is_the_jax_text():
    """Outside pure data parallelism the explicit exchange is refused with
    the JAX package's text (the engine raises it at init: ``tp_scope``
    below)."""
    from types import SimpleNamespace as NS
    from deepspeed_tpu.runtime.zero.compressed_step import \
        explicit_scope_error as jax_scope
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.zero.compressed_step import \
        explicit_scope_error
    for mm in (NS(pp=1, tp=2, sp=1, ep=1), NS(pp=1, tp=1, sp=1, ep=1)):
        want = jax_scope(NS(mesh_manager=mm, _offload=None,
                            _param_runner=None), "overlap_schedule")
        got = explicit_scope_error(NS(mesh_manager=mm, _config=DeepSpeedConfig(
            zp.config(2), world_size=2)), "overlap_schedule")
        assert got == want


def test_engine_at_tp2_raises_the_scope_error(dp4):
    """``initialize`` at dp 2 x tp 2 with an int8 policy raises
    ``ConfigError`` with the scope text (rank results of the 4-rank
    spawn)."""
    _, ranks = dp4
    for r in ranks:
        assert r[-1]["tp_scope"].startswith(
            "ConfigError: comm_compression: the explicit ZeRO exchange "
            "supports pure data parallelism only")
