"""Serving at tensor-parallel size 2 on an NCCL group of two GPUs: the
group a multi-card deployment runs, which carries CUDA tensors only (the
CPU tests run gloo, which carries both). A small GPT-2 on the plain
attention path (no kernel build) is served without deadlines, then with
deadlines under clocks 100 s apart on the two ranks: both ranks serve the
same streams and expire the same requests at the same tick. Needs two
NVIDIA GPUs and skips elsewhere. This file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_tp_serving.py
"""

import os
import pickle

import pytest
import torch

GPT2 = dict(vocab_size=64, n_positions=128, n_embd=64, n_layer=2, n_head=4,
            pad_vocab_to_multiple=8, attn_backend="xla")
PROMPTS = ([3, 9, 27, 17], [5, 1, 4, 1, 5, 9, 2, 6], [8, 8, 2], [11, 13])
# the clock before each tick on rank 0 (rank 1 reads it 100 s later)
SCRIPT = (0.0, 1.0, 10.0, 20.0, 40.0)


def _serve(engine, cfg, timeouts, clock=None):
    from deepspeed_tpu_torch.serving import SamplingParams, ServingEngine
    now = [0.0]
    kw = {} if clock is None else {"clock": lambda: clock(now[0])}
    srv = ServingEngine(engine, cfg, **kw)
    rids = [srv.submit(p, SamplingParams(max_new_tokens=6, timeout_s=t))
            for p, t in zip(PROMPTS, timeouts)]
    states = []
    for t in SCRIPT if clock is not None else ():
        now[0] = t
        srv.step()
        states.append([srv.result(r).state.value for r in rids])
    srv.run_until_idle()
    states.append([srv.result(r).state.value for r in rids])
    out = [list(srv.result(r).tokens) for r in rids]
    srv.shutdown()
    return states, out


def _rank(rank, store, out_dir):
    os.environ["LOCAL_RANK"] = str(rank)
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.parallel.topology import initialize_mesh
    comm.init_distributed("nccl", init_method=f"file://{store}", rank=rank,
                          world_size=2, timeout=120, verbose=False)
    try:
        initialize_mesh(tp=2)
        model = GPT2Model(GPT2Config(**GPT2),
                          generator=torch.Generator().manual_seed(0))
        engine = deepspeed_tpu_torch.init_inference(
            model, {"dtype": "float32", "tensor_parallel": {"tp_size": 2}})
        out = {"plain": _serve(engine, {"num_slots": 2, "max_model_len": 64},
                               (None,) * len(PROMPTS)),
               "deadlines": _serve(
                   engine, {"num_slots": 1, "max_model_len": 64,
                            "request_timeout_s": 30.0},
                   (None, 5.0, None, None),
                   clock=lambda t: t + 100.0 * rank)}
    finally:
        comm.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.mark.cuda
def test_tp_serving_with_deadlines_on_an_nccl_group(tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (an NCCL group of two ranks)")
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(tmp_path / "store"),
                                             str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    outs = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    assert outs[0] == outs[1]
    states, streams = outs[0]["plain"]
    assert states == [["finished"] * len(PROMPTS)]
    assert all(len(s) == 6 for s in streams)
    # one slot: request 0 runs, the 5 s one expires at 10 in the queue,
    # and at 40 the rest are past the 30 s default
    states, streams = outs[0]["deadlines"]
    run, que, out = "running", "queued", "timeout"
    assert states == [[run, que, que, que]] * 2 + [[run, out, que, que]] * 2 \
        + [[out] * 4] * 2
    assert len(streams[0]) == 5 and streams[1:] == [[], [], []]
