#!/usr/bin/env python3
"""Whether two gloo ranks can share one GPU for the port's tensor parallel.

    python3 scripts/check_torch_tp_two_ranks_one_card.py [--steps 2]

NCCL takes no two ranks on one device. This starts two processes on card
0 joined by a gloo group (a free localhost port) and tries, in order: a
gloo all-reduce and all-gather of CUDA tensors; a DTensor gathered whole
over a ``model=2`` mesh of device type ``cuda``; and ``dit_forget`` under
``parallelism="tp"`` on a depth-2 DiT-S/2 in float32 at 256 px (AdamW,
``ga``, EMA, a dense mask, ``--steps`` steps at 8 + 8 seeded latents),
whose parameters are then held to the same run on one device within the
CPU tests' bounds (rtol 2e-4, atol 2e-5). Each rank prints the stage it
starts (a rank killed by a signal leaves its last stage in the output);
each stage's outcome and, for the last, the largest difference and the
run's ms on each side go to stdout; the last line is one JSON object.
Exits 0 whether or not the stages pass (the answer is the output); 2
without CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 2e-5
BATCH = 8


def _dit_run(mesh, steps: int, out: dict) -> dict:
    """``dit_forget`` under ``mesh`` (None: one device); whole parameters
    on the host and the run's ms."""
    import numpy as np
    import torch

    from uurg_torch.parallel.mesh import full_state_dict
    from uurg_torch.workloads import dit_runner as DR
    from uurg_torch.workloads.dit import DiTWorkload

    wl = DiTWorkload.build("DiT-S/2", 256, 10, dtype=torch.float32,
                           device="cuda", depth=2)
    rng = np.random.default_rng(0)

    def batch():
        return (torch.from_numpy(rng.standard_normal((BATCH, 32, 32, 4))
                                 .astype(np.float32)),
                torch.from_numpy(rng.integers(0, 10, BATCH)))

    fbs = [batch() for _ in range(steps)]
    rbs = [batch() for _ in range(steps)]
    model = wl.init_params(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    mask = {n: torch.rand(p.shape, generator=gen, device="cuda") < 0.6
            for n, p in model.named_parameters()}
    place = {} if mesh is None else {"mesh": mesh, "parallelism": "tp"}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = DR.dit_forget(wl, model, iter(fbs), iter(rbs), n_iters=steps,
                          lr=1e-3, forget_alpha=0.5, unlearn_loss="ga",
                          mask=mask, ema_decay=0.999, seed=3,
                          log_freq=10 ** 6, **place)
    torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t0) * 1e3
    return full_state_dict(state.model)


def _rank(r: int, port: int, steps: int, path: str) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.cuda.set_device(0)
    out = {"rank": r, "stages": {}}

    def stage(name: str) -> None:     # a crash's output names its stage
        print(f"rank {r}: {name}", flush=True)

    try:
        stage("gloo group")
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=r)
        stage("collectives of CUDA tensors")
        x = torch.full((4,), float(r + 1), device="cuda")
        dist.all_reduce(x)
        parts = [torch.empty(2, device="cuda") for _ in range(2)]
        dist.all_gather(parts, torch.full((2,), float(r), device="cuda"))
        out["stages"]["collectives"] = bool(
            (x == 3).all() and torch.equal(torch.cat(parts).cpu(),
                                           torch.tensor([0., 0., 1., 1.])))
        from torch.distributed.tensor import DTensor, Shard

        from uurg_torch.parallel.mesh import make_mesh

        stage("a DTensor gathered whole")
        mesh = make_mesh({"model": 2}, device_type="cuda")
        whole = torch.arange(8., device="cuda")
        dt = DTensor.from_local(whole.chunk(2)[r], mesh["model"], [Shard(0)],
                                run_check=False)
        out["stages"]["dtensor"] = bool(torch.equal(dt.full_tensor(), whole))
        stage("dit_forget tp")
        params = _dit_run(mesh, steps, out)
        if r == 0:
            torch.save(params, path)
        out["stages"]["dit_forget"] = "ran"
    except Exception:                      # the answer: where it stopped
        out["error"] = traceback.format_exc(limit=4)[-1500:]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(f"{path}.rank{r}.json", "w") as f:
        json.dump(out, f)


def main() -> int:
    import tempfile

    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    from uurg_torch.ops import _build
    from uurg_torch.parallel.dist import free_port

    _build.build_all()
    work = tempfile.mkdtemp(prefix="uurg_tp2_")
    path = os.path.join(work, "params.pt")
    try:
        mp.spawn(_rank, args=(free_port(), args.steps, path), nprocs=2,
                 join=True)
    except mp.ProcessExitedException as e:     # a rank killed by a signal
        print(json.dumps({"two_gloo_ranks_one_card": False,
                          "card": torch.cuda.get_device_name(0),
                          "errors": [str(e)]}))
        return 0
    ranks = []
    for r in range(2):
        with open(f"{path}.rank{r}.json") as f:
            ranks.append(json.load(f))
        print(f"rank {r}: {ranks[-1]}", flush=True)
    result = {"two_gloo_ranks_one_card": False,
              "card": torch.cuda.get_device_name(0),
              "stages": ranks[0]["stages"],
              "errors": [g.get("error") for g in ranks]}
    if os.path.exists(path) and not any(result["errors"]):
        got = torch.load(path)
        one = {}
        want = _dit_run(None, args.steps, one)
        worst = max(float(((got[k] - w).abs() - RTOL * w.abs()).max())
                    for k, w in want.items())
        moved = any(not torch.equal(got[k], w) for k, w in want.items())
        ok = worst <= ATOL
        print(f"dit_forget tp model=2 on one card against one device: "
              f"largest excess over rtol {worst:.3e} (atol {ATOL}), "
              f"{ranks[0]['ms']:.1f} ms against {one['ms']:.1f} ms "
              f"(first calls, kernels loaded); differs bitwise: {moved}",
              flush=True)
        result.update(two_gloo_ranks_one_card=ok, excess_over_rtol=worst,
                      ms=ranks[0]["ms"], one_device_ms=one["ms"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
