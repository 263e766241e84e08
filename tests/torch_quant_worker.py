"""Rank workers of the quantization tests (the compressed collectives, the
explicit and bucketed ZeRO exchanges). Imports no JAX: the ranks run the
port on numpy inputs the tests made and return numpy results
(``torch_dist_worker.spawn``)."""

import numpy as np
import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm import compression
from deepspeed_tpu_torch.parallel import topology

import torch_dist_worker as tdw


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy() \
        if t.dtype not in (torch.int8,) else t.detach().cpu().numpy()


def collective_cases(rank, world, payload):
    """Each call of ``payload["calls"]`` under its policy: ``(op, policy
    dict, inputs by rank, kwargs)``; per call the result, the wire bytes
    and the inter-host bytes it accounted, and its op count."""
    topology.initialize_mesh(dp=world)
    out = []
    for op, cc, inputs, kw in payload["calls"]:
        compression.configure_comm_compression(cc)
        comm.reset_comm_stats()
        x = inputs[rank]
        if isinstance(x, list):
            xs = [torch.from_numpy(a) for a in x]
        else:
            xs = torch.from_numpy(x)
        dtype = kw.pop("dtype", None)
        if dtype is not None:
            xs = [t.to(getattr(torch, dtype)) for t in xs] \
                if isinstance(xs, list) else xs.to(getattr(torch, dtype))
        fn = getattr(comm, op)
        if op in ("all_reduce", "broadcast"):
            res = fn(xs.clone(), **kw)
        else:
            res = fn(xs, **kw)
        if isinstance(res, list):
            res = [_np(r) for r in res]
        else:
            res = _np(res)
        st = comm.comm_stats()
        out.append({"result": res, "bytes": st["bytes"],
                    "inter": st["inter_host_bytes"],
                    "intra": st["intra_host_bytes"],
                    "logical": st["logical_bytes"], "ops": st["ops"]})
    compression.reset_comm_compression()
    return out


def _record_exchange(calls):
    """Wrap the comm layer's ``reduce_scatter`` / ``all_reduce`` to record
    the explicit exchange's inputs (each rank's unreduced gradients)."""
    saved = (comm.reduce_scatter, comm.all_reduce)

    def rs(x, axis_name="data", axis=0, op=comm.ReduceOp.SUM):
        calls.append(("rs", axis, x.detach().float().cpu().numpy().copy()))
        return saved[0](x, axis_name, axis, op)

    def ar(x, op=comm.ReduceOp.SUM, axis_name="data"):
        if x.numel() > 1:
            calls.append(("ar", 0, x.detach().float().cpu().numpy().copy()))
        return saved[1](x, op, axis_name)
    comm.reduce_scatter, comm.all_reduce = rs, ar
    return saved


def _whole_grads(engine):
    """The accumulated gradients, gathered whole, as a JAX tree of numpy
    (a collective)."""
    whole = []
    for i, g in enumerate(engine._grad_acc):
        ps = engine._pshards[i]
        # shards from stage 2 on; stage 1 holds whole gradients
        sharded = ps.partitioned and engine._stage >= 2
        whole.append(engine.whole(i, g) if sharded else g)
    return engine.module.jax_tree([w.detach().float().cpu()
                                   for w in whole])


def compressed_cases(rank, world, payload):
    """Each case: an engine from the case's weights and config; one micro
    step (forward + backward on the first micro batch), its whole
    gradients and every rank's exchanged inputs by leaf; then the case's
    global steps, the state, the accounting and (bucketed) the issue
    order."""
    topology.initialize_mesh(dp=world)
    results = []
    for case in payload["cases"]:
        engine = tdw.engine_for(case)
        first = {k: v[0] for k, v in case["batches"][0].items()}
        calls = []
        saved = _record_exchange(calls)
        try:
            engine.backward(engine(first))
        finally:
            comm.reduce_scatter, comm.all_reduce = saved
        tree = _whole_grads(engine)
        grads = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                for n, t in v.items():
                    grads[f"{k}/{n}"] = t.numpy()
            else:
                grads[k] = v.numpy()
        xfn = engine._compressed_micro_grad(None) if engine._explicit \
            else None
        names = [lf.name for lf in xfn.leaves] if xfn is not None else []
        local = {n: c for n, c in zip(names, calls)}
        gathered = [None] * world
        torch.distributed.all_gather_object(gathered, local)
        issue = list(getattr(xfn, "issue_log", []))
        engine._drop_step_state()
        comm.reset_comm_stats()
        steps = tdw.run_steps(engine, case["batches"])
        stats = comm.comm_stats()
        st = tdw.state(engine)
        results.append({
            "grads": grads if rank == 0 else None,
            "local": gathered if rank == 0 else None,
            "steps": steps, "state": st if rank == 0 else None,
            "stats": stats, "issue": issue,
            "summary": engine.summary(),
            "explicit": bool(engine._explicit)})
    if payload.get("tp_scope") is not None:
        topology.initialize_mesh(tp=2)      # dp = world / 2
        try:
            tdw.engine_for(dict(payload["tp_scope"], tree=None))
            results.append({"tp_scope": "no error"})
        except Exception as e:   # the ConfigError the test reads
            results.append({"tp_scope": f"{type(e).__name__}: {e}"})
    compression.reset_comm_compression()
    return results


def int8_serving(rank, world, payload):
    """Each case at tp ``world`` with int8 weights (f32 compute): the
    logits, greedy and sampled ``generate`` streams, and each rank's
    dequantized weights against its part of the JAX package's whole
    dequantized leaves (``payload["dequant"]``)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import quantization as tq
    import torch_tp_worker
    topology.initialize_mesh(tp=world)
    out = []
    for case in payload["cases"]:
        m = torch_tp_worker.model(case["family"], case["kw"], case["tree"])
        engine = deepspeed_tpu_torch.init_inference(
            m, {"dtype": "float32", "quant": {"enabled": True}},
            device="cpu")
        res = {"tp": engine.tp.size}
        with torch.inference_mode():
            res["logits"] = engine(torch.as_tensor(case["ids"])).numpy()
        res["generate"] = [engine.generate(np.asarray(p)[None], **kw)[0]
                           .numpy() for p, kw in case["generate"]]
        worst, n_q = 0.0, 0
        for (leaf, layer), p, split in zip(m.jax_layout(), m.parameters(),
                                           m.tp_splits()):
            if not tq.is_quantized(p):
                continue
            n_q += 1
            whole = torch.from_numpy(case["dequant"][leaf])
            if layer is not None:
                whole = whole[layer]
            want = whole if split is None else split.take(whole)
            got = p.dequantize(torch.float32)
            worst = max(worst, float((got - want).abs().max()))
        res["dequant_worst"], res["n_quantized"] = worst, n_q
        out.append(res)
    return out
