"""Rank workers for the multi-rank CPU tests of ``uurg_torch.parallel``.

Not a test module: ``tests/test_torch_parallel*.py`` start these functions
on gloo ranks with :func:`spawn` (``torch.multiprocessing``, one intra-op
thread a rank) and call the same run functions in their own process, with
no group, for the one-process reference. Ranks read their inputs from and
write their results to files in the test's ``tmp_path``, whole tensors
only. Nothing here imports JAX.
"""
from __future__ import annotations

import contextlib
import os
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from uurg_torch.core.tree import PackedMask
from uurg_torch.parallel.dist import (free_port, initialize_single, rank,
                                      sync_global_devices, world_size)
from uurg_torch.parallel.mesh import (DIT_TP_RULES, data_group,
                                      full_optimizer_state, full_state_dict,
                                      full_tensor, local, local_rows,
                                      make_mesh, parse_mesh_spec, place_like,
                                      shard_batch, shard_params_fsdp,
                                      shard_params_tp, split_batches)

# the tiny CondUNet of tests/test_torch_sfron.py
TINY_UNET = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                 attn_resolutions=(16,), dropout=0.0, resolution=32)
# a depth-2 DiT-S/2 at 8 x 8 latents
DIT = dict(name="DiT-S/2", image_size=64, num_classes=10, depth=2)
# SD's TINY_UNET at 32 channels, so that FSDP's 2**14 floor shards some
SD_UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
               attention_ds=(1, 2), num_heads=2, context_dim=16)
SD_TEXT = dict(vocab_size=49408, max_length=8, hidden_size=16, depth=2,
               num_heads=2)
SD_VAE = dict(base_channels=8, channel_mult=(1, 1), num_res_blocks=1)


@contextlib.contextmanager
def one_rank_group():
    """A gloo group of this process alone for the block (the one-rank
    mesh of the CPU tests), torn down after it."""
    initialize_single("cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


# the longest a group of ranks may take (the slowest, four ranks through
# two runners, takes about 30 s on one CPU core a rank)
SPAWN_SECONDS = 300


def spawn(name: str, world: int, out_dir, *args,
          timeout: float = SPAWN_SECONDS) -> None:
    """Run ``name(out_dir, *args)`` of this module on ``world`` gloo ranks
    and wait for all of them; a rank that raises fails the call, and so
    do ranks still running after ``timeout`` seconds (a schedule whose
    ranks wait on each other for ever): they are killed and
    ``TimeoutError`` names ``name``. A port that another process took
    between ``free_port`` and the group's listen (test workers start
    groups side by side) is tried again on another, twice at most."""
    for attempt in range(3):
        ranks = mp.start_processes(
            _entry, args=(world, free_port(), name, str(out_dir), args),
            nprocs=world, join=False, start_method="spawn")
        try:
            _join(ranks, name, world, timeout)
            return
        except mp.ProcessRaisedException as e:
            if "EADDRINUSE" not in str(e) or attempt == 2:
                raise


def _join(ranks, name: str, world: int, timeout: float) -> None:
    """Wait for ``ranks`` (a ``ProcessContext``) until ``timeout``
    seconds have passed; then kill them and raise ``TimeoutError``."""
    deadline = time.monotonic() + timeout
    while not ranks.join(timeout=max(0.0, min(
            5.0, deadline - time.monotonic()))):
        if time.monotonic() >= deadline:
            for p in ranks.processes:
                if p.is_alive():
                    p.kill()
            for p in ranks.processes:
                p.join()
            raise TimeoutError(f"{name} on {world} ranks did not finish "
                               f"within {timeout:g} s; its ranks were "
                               f"killed")


def _entry(r: int, world: int, port: int, name: str, out: str, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=r)
    try:
        globals()[name](out, *args)
    finally:
        dist.destroy_process_group()


def wait_for_ever(out: str) -> None:
    """Each of two ranks waits for a tensor from the other, which no rank
    sends: a deadlock, for the test of :func:`spawn`'s time limit."""
    dist.recv(torch.zeros(1), src=1 - rank())


def _save(out: str, tag: str, payload) -> None:
    torch.save(payload, os.path.join(out, f"{tag}_rank{rank()}.pt"))


def _mesh(spec: str | None):
    return make_mesh(parse_mesh_spec(spec)) if spec else None


def _full_params(model) -> dict:
    return {k: v.clone() for k, v in full_state_dict(model).items()}


# -- DDPM: the SFR-on step under data parallel --------------------------------


def ddpm_workload(tmp: str):
    from uurg_torch.workloads.ddpm import DDPMWorkload

    return DDPMWorkload.from_config(ddpm_config(tmp), torch.float32, "cpu")


def ddpm_config(tmp: str, **training):
    from uurg_torch.core.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "cifar10_sfron.yml"))
    model = {**cfg.model.to_dict(), "ch": 32, "ch_mult": [1, 2],
             "num_res_blocks": 1, "dropout": 0.0}
    train = {**cfg.training.to_dict(), "batch_size": 16, "n_iters": 2,
             "snapshot_freq": 1, "log_freq": 1, **training}
    data = {**cfg.data.to_dict(), "path": os.path.join(tmp, "no_cifar"),
            "synthetic_n": 64}
    # SGD: Adam turns the bf16 rounding that two ranks' half batches change
    # into +-lr moves of the gradients that are near zero
    optim = {**cfg.optim.to_dict(), "optimizer": "SGD", "lr": 1e-3}
    return cfg.merged({"model": model, "training": train, "data": data,
                       "optim": optim, "sampling": {"batch_size": 4}})


def ddpm_step_run(inputs: dict, mesh, loss: str = "draws",
                  local_adaga: bool = False) -> dict:
    """Steps of the tiny CondUNet's SFR-on (adaga forget, SGD with momentum
    0.9, cosine alpha, both clips 1.0) on ``inputs``' global batches.
    ``loss="draws"``: the workload's losses with their own draws (label
    dropout 0.1); ``"injected"``: batches carry (x, c, t, noise, keep).
    ``local_adaga`` normalizes the adaptive weights over each rank's rows
    alone (the mistake the global sum prevents)."""
    from uurg_torch.diffusion import losses as L
    from uurg_torch.models.unet_cond import CondUNet, UNetConfig
    from uurg_torch.parallel import mesh as M
    from uurg_torch.train.optim import make_optimizer
    from uurg_torch.unlearn import sfron as S

    wl = ddpm_workload(inputs["tmp"])
    model = CondUNet(UNetConfig(dtype=torch.float32, **TINY_UNET))
    model.load_state_dict(inputs["state"])
    model.train()
    opt = make_optimizer("sgd", model.parameters(), inputs["lr"],
                         momentum=0.9)
    cfg = S.SFRonConfig(n_iters=10, forget_alpha=1.0, alpha_sched="cosine",
                        forget_clip=1.0, remain_clip=1.0)
    if loss == "draws":
        forget_fn, remain_fn = wl.adaga_forget_loss_fn(), wl.train_loss_fn()
    else:
        def per(m, b):
            x, c, t, noise, keep = b
            return wl.per_sample_eps_loss(m, x, c, t, noise, keep)

        def forget_fn(m, b, g):
            return -L.adaptive_loss(per(m, b), 0.5, eps=1e-8)

        def remain_fn(m, b, g):
            return per(m, b).mean()
    step = S.make_sfron_step(cfg, forget_fn, remain_fn)
    state = S.init_state(model, opt, group=data_group(mesh))
    gen = torch.Generator()
    metrics = []
    saved = L.batch_split
    if local_adaga:
        L.batch_split = M.BatchSplit
    try:
        with split_batches(mesh):
            for i, (fb, rb) in enumerate(inputs["batches"]):
                gen.manual_seed(100 + i)
                m = step(state, shard_batch(fb, mesh), shard_batch(rb, mesh),
                         gen)
                metrics.append({k: float(m[k]) for k in
                                ("forget_loss", "remain_loss",
                                 "remain_grad_norm")})
    finally:
        L.batch_split = saved
    return {"params": _full_params(model), "metrics": metrics}


def ddpm_step(out: str, inputs_path: str) -> None:
    inputs = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh({"data": world_size()})
    _save(out, "ddpm_step", {
        "draws": ddpm_step_run(inputs, mesh, "draws"),
        "local_adaga": ddpm_step_run(inputs, mesh, "draws",
                                     local_adaga=True),
        "injected": ddpm_step_run(inputs["injected"], mesh, "injected")})


# -- DDPM: the runner ---------------------------------------------------------


class Args:
    """The runner's argparse namespace."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def ddpm_runner_run(tmp: str, run: str, n_iters: int) -> dict:
    """``sfron_forget`` (adaga, cosine alpha) on the tiny config's
    synthetic stand-in for ``n_iters`` steps in ``<tmp>/<run>``, resuming
    from its ``ckpt.pth``; which ranks wrote the file, each time."""
    from uurg_torch.io import jax_interop
    from uurg_torch.workloads import ddpm_runner as R

    config = ddpm_config(tmp, n_iters=n_iters)
    args = Args(seed=3, label_to_forget=0, forget_alpha=1.0,
                decay_forget_alpha=True, unlearn_loss="adaga",
                ckpt_folder=None)
    writes = []
    save = jax_interop.save_reference_checkpoint

    def counted(path, *a, **k):
        writes.append(rank())
        return save(path, *a, **k)

    R.save_reference_checkpoint = counted
    try:
        state = R.sfron_forget(args, config, os.path.join(tmp, run),
                               device="cpu")
    finally:
        R.save_reference_checkpoint = save
    return {"params": _full_params(state.model),
            "ema": _full_params(state.ema_model), "writes": writes,
            "step": state.step}


def ddpm_sample_run(tmp: str) -> np.ndarray:
    """``sample_images`` of 6 labels (DDIM, 4 steps, CFG 2, batch 4: the
    last one padded) from the tiny config's seeded bf16 model."""
    from uurg_torch.workloads import ddpm_runner as R
    from uurg_torch.workloads.ddpm import DDPMWorkload

    config = ddpm_config(tmp)
    model = DDPMWorkload.from_config(config, device="cpu").init_params(3)
    return R.sample_images(Args(), config, model, np.arange(1, 7),
                           num_steps=4, batch_size=4, seed=7)


def mesh_rules() -> dict:
    """``make_mesh`` on every rank: -1 fills, too many ranks raise, fewer
    warn."""
    from uurg_torch.parallel.mesh import mesh_shape

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        small = make_mesh({"data": 1})
    try:
        make_mesh({"data": 2 * world_size()})
        error = None
    except ValueError as e:
        error = str(e)
    return {"fill": mesh_shape(make_mesh({"data": 1, "model": -1})),
            "small": mesh_shape(small), "error": error,
            "warned": [str(w.message) for w in caught]}


def ddpm_runner(out: str, tmp: str) -> None:
    _save(out, "ddpm_runner", {"mesh_rules": mesh_rules(),
        "straight": ddpm_runner_run(tmp, "straight", 2),
        "first": ddpm_runner_run(tmp, "resumed", 1),
        "resumed": ddpm_runner_run(tmp, "resumed", 2),
        "images": ddpm_sample_run(tmp)})


# -- DiT: the FSDP step, the runner and the sampler ---------------------------


def dit_workload():
    from uurg_torch.workloads.dit import DiTWorkload

    kw = dict(DIT)
    return DiTWorkload.build(kw.pop("name"), kw.pop("image_size"),
                             kw.pop("num_classes"), dtype=torch.float32,
                             device="cpu", **kw)


def dit_model(state: dict):
    from uurg_torch.models.dit import DiT

    model = DiT(dit_workload().cfg)
    model.load_state_dict(state)
    return model


def dit_step_run(inputs: dict, mesh, min_size: int = 64,
                 pack: bool = False, parallelism: str = "fsdp") -> dict:
    """Two SFR-on steps of the depth-2 DiT-S/2 (AdamW 1e-3, ``ga`` forget
    loss, const alpha, forget clip 1.0, EMA 0.999, a dense or packed
    mask), the model, its shadow, the Adam moments and a dense mask
    sharded over ``mesh`` by ``shard_params_fsdp(min_size=min_size)``, or
    placed by ``DIT_TP_RULES`` under ``parallelism="tp"``. With
    ``inputs["draws"]`` (each loss call's global t and noise, in order)
    the losses take those draws, cut to this rank's rows. Returns whole
    tensors, each rank's shard sizes and the local shards of the first
    block's qkv weight, Adam moment and mask."""
    from uurg_torch.core.tree import pack_mask
    from uurg_torch.train.optim import make_optimizer
    from uurg_torch.unlearn import sfron as S

    wl = dit_workload()
    if "draws" in inputs:
        queue = list(inputs["draws"])
        wl._draw = lambda x, g: tuple(local_rows(a) for a in queue.pop(0))
    model = dit_model(inputs["state"]).train()
    shadow = S.make_shadow(model)
    if mesh is not None:
        for m in (model, shadow):
            if parallelism == "tp":
                shard_params_tp(m, mesh, DIT_TP_RULES)
            else:
                shard_params_fsdp(m, mesh, min_size=min_size)
    opt = make_optimizer("adamw", model.parameters(), 1e-3,
                         weight_decay=0.0)
    for group in opt.param_groups:
        # the multi-tensor kernels torch.optim takes on the card (on the
        # CPU it loops): no _foreach op takes FSDP's mixed list
        group["foreach"] = True
    mask = inputs["mask"]
    mask = pack_mask(mask) if pack else place_like(mask, model)
    cfg = S.SFRonConfig(n_iters=10, forget_alpha=0.5, alpha_sched="const",
                        forget_clip=1.0, remain_clip=None, ema_mu=0.999)
    step = S.make_sfron_step(cfg, wl.ga_forget_loss_fn(),
                             wl.train_loss_fn())
    state = S.init_state(model, opt, ema=True, mask=mask, ema_model=shadow,
                         group=data_group(mesh))
    gen = torch.Generator()
    losses = []
    with split_batches(mesh):
        for i, (fb, rb) in enumerate(inputs["batches"]):
            gen.manual_seed(50 + i)
            m = step(state, shard_batch(fb, mesh), shard_batch(rb, mesh), gen)
            losses.append([float(m["forget_loss"]), float(m["remain_loss"])])
    params = dict(model.named_parameters())
    shadow_p = dict(shadow.named_parameters())
    moments = {n: opt.state[p]["exp_avg"] for n, p in params.items()}
    sizes = {n: (local(p).numel(), local(moments[n]).numel(),
                 local(shadow_p[n]).numel(),
                 None if pack else local(mask[n]).numel())
             for n, p in params.items()}
    opt_full = full_optimizer_state(opt)
    qkv = "blocks.0.attn.qkv.weight"
    return {"params": _full_params(model), "ema": _full_params(shadow),
            "exp_avg": [opt_full["state"][i]["exp_avg"]
                        for i in range(len(params))],
            "losses": losses, "sizes": sizes,
            "packed": all(isinstance(v, PackedMask)
                          for v in state.mask.values()),
            "qkv_local": {"param": local(params[qkv]).detach().clone(),
                          "exp_avg": local(moments[qkv]).clone(),
                          "mask": None if pack else local(mask[qkv])}}


def dit_step(out: str, inputs_path: str, spec: str) -> None:
    inputs = torch.load(inputs_path, weights_only=False)
    mesh = _mesh(spec)
    _save(out, "dit_step", {"dense": dit_step_run(inputs, mesh),
                            "packed": dit_step_run(inputs, mesh, pack=True)})


def dit_tp_step(out: str, inputs_path: str, spec: str) -> None:
    inputs = torch.load(inputs_path, weights_only=False)
    _save(out, "dit_tp_step", dit_step_run(inputs, _mesh(spec),
                                           parallelism="tp"))


def dit_runner_run(inputs: dict, ckpt_dir: str | None, n_iters: int,
                   mesh, parallelism: str = "fsdp", pack: bool = True,
                   **kw) -> dict:
    """``dit_forget`` (AdamW, ``ga``, a packed or dense mask) for
    ``n_iters`` steps, resuming from ``ckpt_dir``'s train state, writing
    it every step; which ranks wrote which files, each step's metrics, the
    Adam state whole and each parameter's local sizes (the parameter, its
    first moment, its shadow, its mask or None when packed). ``kw`` goes
    to ``dit_forget``."""
    from uurg_torch.unlearn import sfron
    from uurg_torch.workloads import dit_runner

    model = dit_model(inputs["state"])
    writes, save, metrics = [], torch.save, []

    def recorded(obj, path, *a, **k):
        writes.append((rank(), os.path.basename(str(path))))
        return save(obj, path, *a, **k)

    def recording(*a, **k):
        step = sfron.make_sfron_step(*a, **k)

        def run(*sa):
            m = step(*sa)
            metrics.append({n: float(m[n]) for n in
                            ("forget_loss", "remain_loss",
                             "remain_grad_norm")})
            return m

        return run

    torch.save, dit_runner.make_sfron_step = recorded, recording
    try:
        state = dit_runner.dit_forget(
            dit_workload(), model, iter(inputs["batches_f"]),
            iter(inputs["batches_r"]), n_iters=n_iters, lr=1e-3,
            forget_alpha=0.5, unlearn_loss="ga", mask=inputs["mask"],
            pack_mask=pack, ema_decay=0.999, seed=4, log_freq=100,
            ckpt_dir=ckpt_dir, ckpt_freq=1, mesh=mesh,
            parallelism=parallelism, **kw)
    finally:
        torch.save, dit_runner.make_sfron_step = save, sfron.make_sfron_step
    params = dict(state.model.named_parameters())
    shadow = dict(state.ema_model.named_parameters())
    opt = state.optimizer
    return {"params": _full_params(state.model),
            "ema": _full_params(state.ema_model), "writes": writes,
            "metrics": metrics, "opt": full_optimizer_state(opt),
            "sizes": {n: (local(p).numel(),
                          local(opt.state[p]["exp_avg"]).numel(),
                          local(shadow[n]).numel(),
                          None if pack else local(state.mask[n]).numel())
                      for n, p in params.items()}}


def dit_runner(out: str, inputs_path: str, tmp: str) -> None:
    from uurg_torch.workloads.dit_runner import dit_sample_fid

    inputs = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh({"data": world_size()})
    straight = dit_runner_run(inputs, None, 2, mesh)
    ckpt = os.path.join(tmp, "dit_ckpt")
    first = dit_runner_run(inputs, ckpt, 1, mesh)
    resumed = dit_runner_run(inputs, ckpt, 2, mesh)
    latents = dit_sample_fid(dit_workload(), dit_model(inputs["state"]),
                             np.arange(6) % 10, respacing="3",
                             batch_size=2, seed=9)
    _save(out, "dit_runner", {"straight": straight, "first": first,
                              "resumed": resumed, "latents": latents})


def dit_tp_runner(out: str, inputs_path: str, tmp: str) -> None:
    """``dit_forget`` under tensor parallel on a ``model`` axis of every
    rank: straight, cut after one step and resumed; rank 0 writes the
    files."""
    inputs = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh({"model": world_size()})
    ckpt = os.path.join(tmp, "dit_tp_ckpt")
    _save(out, "dit_tp_runner", {
        "straight": dit_runner_run(inputs, None, 2, mesh, "tp"),
        "first": dit_runner_run(inputs, ckpt, 1, mesh, "tp"),
        "resumed": dit_runner_run(inputs, ckpt, 2, mesh, "tp")})


def dit_sample_cli(out: str, *runs: list) -> None:
    """``uurg_torch.cli.dit_sample``'s ``main`` on each argument list in
    turn, on this rank, as under ``torchrun`` (the group up first)."""
    from uurg_torch.cli import dit_sample

    for argv in runs:
        dit_sample.main(argv)


# -- SD: nsfw_removal ---------------------------------------------------------


def sd_workload():
    from uurg_torch.models.autoencoder_kl import VAEConfig
    from uurg_torch.models.clip_text import CLIPTextConfig
    from uurg_torch.models.sd_unet import SDUNetConfig
    from uurg_torch.workloads.sd import SDWorkload

    return SDWorkload.build(SDUNetConfig(**SD_UNET, dtype=torch.float32,
                                         remat=False),
                            VAEConfig(**SD_VAE), CLIPTextConfig(**SD_TEXT),
                            device="cpu")


def sd_run(inputs: dict, mesh, parallelism: str = "fsdp",
           adam: bool = False, pack: bool = True) -> dict:
    """One ``nsfw_removal`` step with a packed (or dense) mask, then the
    UNet through ``save_unet``: SGD with momentum 0.9, or the runner's own
    Adam (first moment bf16) at an eps of 1e-3 (at 1e-8 Adam turns the
    gradients that are zero in exact arithmetic, conv biases before a
    GroupNorm, into +-lr moves of either sign), its moments kept
    whole."""
    from uurg_torch.cli.sd_common import save_unet
    from uurg_torch.models.sd_unet import SDUNet
    from uurg_torch.train.optim import make_optimizer
    from uurg_torch.workloads import sd_runner

    wl = sd_workload()
    model = SDUNet(wl.unet_cfg)
    model.load_state_dict(inputs["state"])
    if adam:
        sd_runner.make_optimizer = lambda name, params, lr, **kw: \
            make_optimizer(name, params, lr, eps=1e-3, **kw)
    else:
        sd_runner.make_optimizer = lambda name, params, lr, **kw: \
            make_optimizer("sgd", params, lr, momentum=0.9)
    try:
        state = sd_runner.nsfw_removal(
            wl, model, iter(inputs["forget"]), iter(inputs["remain"]),
            n_iters=1, lr=1e-3, saliency_mask=inputs["mask"],
            pack_mask=pack, seed=2, mesh=mesh, parallelism=parallelism)
    finally:
        sd_runner.make_optimizer = make_optimizer
    tag = (f"{parallelism}_{'adam' if adam else 'sgd'}"
           f"{'' if pack else '_dense'}")
    path = os.path.join(inputs["tmp"], f"sd_{tag}_{world_size()}.pt")
    save_unet(path, model)
    sync_global_devices("sd_final")
    params = dict(model.named_parameters())
    mu = {n: state.optimizer.state[p]["mu" if adam else "momentum_buffer"]
          for n, p in params.items()}
    moments = {}
    if adam:
        moments = {n: tuple(full_tensor(state.optimizer.state[p][k],
                                        p).clone()
                            for k in ("mu", "nu"))
                   for n, p in params.items()}
    opt_full = full_optimizer_state(state.optimizer)
    return {"params": _full_params(model), "path": path,
            "moments": moments,
            "momentum": {i: st.get("momentum_buffer", st.get("mu"))
                         for i, st in opt_full["state"].items()},
            "sizes": {n: (local(p).numel(), local(mu[n]).numel())
                      for n, p in params.items()},
            "packed": all(isinstance(v, PackedMask)
                          for v in state.mask.values())}


def sd_resumed(inputs: dict, path: str, mesh) -> dict:
    """``sd_run`` under dp from the UNet that ``save_unet`` wrote to
    ``path`` (read back as ``--ckpt_path`` reads it)."""
    from uurg_torch.io.sd_interop import compvis_unet_to_torch

    state = compvis_unet_to_torch(torch.load(path)["state_dict"],
                                  sd_workload().unet_cfg)
    tmp = os.path.join(os.path.dirname(path), "resumed")
    return sd_run(dict(inputs, state=state, tmp=tmp), mesh, "dp")


def sd(out: str, inputs_path: str) -> None:
    inputs = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh({"data": world_size()})
    runs = {"dp": sd_run(inputs, mesh, "dp"),
            "fsdp": sd_run(inputs, mesh, "fsdp"),
            "fsdp_adam": sd_run(inputs, mesh, "fsdp", adam=True)}
    runs["resumed"] = sd_resumed(inputs, runs["fsdp"]["path"], mesh)
    _save(out, "sd", runs)


def sd_tp(out: str, inputs_path: str) -> None:
    """``nsfw_removal`` under tensor parallel on a ``model`` axis of every
    rank, with a packed and with a dense mask, and under Adam."""
    inputs = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh({"model": world_size()})
    _save(out, "sd_tp", {"packed": sd_run(inputs, mesh, "tp"),
                         "dense": sd_run(inputs, mesh, "tp", pack=False),
                         "adam": sd_run(inputs, mesh, "tp", adam=True)})


# -- the pipeline -------------------------------------------------------------

# tests/test_pipeline.py's DiT: depth 8, hidden 32, 4 heads at 8 x 8 latents
PP_DIT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32,
              depth=8, num_heads=4, num_classes=10)


def pp_model(state: dict):
    from uurg_torch.models.dit import DiT, DiTConfig

    model = DiT(DiTConfig(**PP_DIT, dtype=torch.float32))
    model.load_state_dict(state)
    return model


def pp_apply_run(inputs: dict, mesh, n_mb: int = 1, keep: bool = False
                 ) -> dict:
    """``dit_apply_pipelined`` in ``n_mb`` microbatches on a model placed
    by ``shard_params_pp`` over ``mesh`` (the plain forward without one):
    the output of the global batch and every parameter's gradient of
    mean((out - target)^2) over it, whole; ``keep`` takes the inputs'
    cond-dropout mask. The blocks each rank holds, and their whole shapes
    as recorded."""
    from uurg_torch.parallel.mesh import (all_reduce_mean_, gather_rows,
                                          shard_params_pp, stage_owned,
                                          zeros_like)
    from uurg_torch.parallel.pipeline import dit_apply_pipelined

    model = pp_model(inputs["state"])
    if mesh is not None:
        shard_params_pp(model, mesh)
    for p in model.parameters():
        p.grad = zeros_like(p)
    x, t, y, target, ck = shard_batch(
        tuple(inputs[k] for k in ("x", "t", "y", "target", "keep")), mesh)
    ck = ck if keep else None
    if mesh is None:
        out = model(x, t, y, ck)
    else:
        out = dit_apply_pipelined(model, model.cfg, x, t, y, mesh=mesh,
                                  n_microbatches=n_mb, cond_keep=ck)
    torch.mean((out - target) ** 2).backward()
    if data_group(mesh) is not None:
        all_reduce_mean_([p.grad for p in model.parameters()],
                         data_group(mesh))
    with split_batches(mesh):
        whole = gather_rows(out.detach())
    return {"out": whole,
            "grads": {n: full_tensor(p.grad, p).clone()
                      for n, p in model.named_parameters()},
            "held": [i for i, b in enumerate(model.blocks)
                     if local(b.attn.qkv.weight).numel()],
            "shapes": {n: stage_owned(p).shape
                       for n, p in model.named_parameters()
                       if stage_owned(p) is not None}}


def pp(out: str, inputs_path: str, runs: list, forget_path: str | None,
       tmp: str | None) -> None:
    """``pp_apply_run`` for each ``(mesh spec, microbatches, keep)`` of
    ``runs``; with ``forget_path``, ``dit_forget`` under ``pp`` on a
    ``stage`` axis of every rank (a dense mask; a packed one; cut after
    one step and resumed from its train state), its files in ``tmp``."""
    inputs = torch.load(inputs_path, weights_only=False)
    res = {tuple(run): pp_apply_run(inputs, _mesh(run[0]), *run[1:])
           for run in runs}
    if forget_path is not None:
        data = torch.load(forget_path, weights_only=False)
        mesh = make_mesh({"stage": world_size()})
        res["forget"] = dit_runner_run(data, os.path.join(tmp, "pp_ckpt"), 2,
                                       mesh, "pp", pack=False)
        res["forget_packed"] = dit_runner_run(data, None, 2, mesh, "pp",
                                              pp_microbatches=4)
        cut = os.path.join(tmp, "pp_resume")
        dit_runner_run(data, cut, 1, mesh, "pp", pack=False)
        res["forget_resumed"] = dit_runner_run(data, cut, 2, mesh, "pp",
                                               pack=False)
    _save(out, "pp", res)


# -- ring attention -----------------------------------------------------------


def ring_run(inputs: dict, mesh, grads: bool = True) -> dict:
    """``ring_attention`` over the ``seq`` axis of ``mesh`` on this rank's
    ``data`` rows of ``inputs``' q, k, v: the output of the global batch
    and, with ``grads``, q's, k's and v's gradients of mean((o -
    target)^2) over it."""
    from uurg_torch.parallel.mesh import gather_rows
    from uurg_torch.parallel.sequence import ring_attention

    q, k, v, target = (shard_batch(inputs[n], mesh)
                       for n in ("q", "k", "v", "target"))
    leaves = [t.clone().requires_grad_(grads) for t in (q, k, v)]
    o = ring_attention(*leaves, mesh=mesh)
    out = {}
    with split_batches(mesh) as split:
        out["out"] = gather_rows(o.detach())
        if grads:
            torch.mean((o.float() - target) ** 2).backward()
            out["grads"] = [gather_rows(t.grad) / split.count
                            for t in leaves]
    return out


def ring(out: str, inputs_path: str, specs: list, runners: bool) -> None:
    """``ring_run`` on each mesh spec of ``specs``, in float32 and bf16
    (the forward); with ``runners``, on a ``seq`` axis of every rank:
    ``dit_forget`` and ``nsfw_removal`` under ``sp`` and the SD UNet's
    attention calls counted by route."""
    inputs = torch.load(inputs_path, weights_only=False)
    res = {}
    for spec in specs:
        mesh = _mesh(spec)
        res[spec] = {"f32": ring_run(inputs["f32"][spec], mesh),
                     "bf16": ring_run(inputs["bf16"][spec], mesh,
                                      grads=False)}
    if runners:
        mesh = make_mesh({"seq": world_size()})
        res["dit_forget"] = dit_runner_run(inputs["dit"], None, 2, mesh,
                                           "sp")
        res["nsfw_removal"] = sd_run(inputs["sd"], mesh, "sp")
        res["sd_calls"] = sd_attention_routes(inputs["sd"], mesh)
    _save(out, "ring", res)


def sd_attention_routes(inputs: dict, mesh) -> dict:
    """A forward and backward of the SD UNet under ``sequence_parallel``
    (``mesh`` None: none): how many attention calls reached the dispatcher
    and how many of those took the ring, and the output."""
    from contextlib import nullcontext

    from uurg_torch.models import sd_unet
    from uurg_torch.models.sd_unet import SDUNet
    from uurg_torch.parallel import sequence

    model = SDUNet(sd_workload().unet_cfg)
    model.load_state_dict(inputs["state"])
    calls = {"dispatcher": 0, "ring": 0}
    dispatch, ring_attention = sd_unet.attention, sequence.ring_attention

    def counted(*a, **k):
        calls["dispatcher"] += 1
        return dispatch(*a, **k)

    def ring_counted(*a, **k):
        calls["ring"] += 1
        return ring_attention(*a, **k)

    sd_unet.attention, sequence.ring_attention = counted, ring_counted
    try:
        z, ctx = inputs["remain"][0]
        ctx_mgr = (sequence.sequence_parallel(mesh) if mesh is not None
                   else nullcontext())
        with ctx_mgr:
            out = model(z, torch.arange(z.shape[0]) * 100, ctx)
            out.square().mean().backward()
    finally:
        sd_unet.attention, sequence.ring_attention = dispatch, ring_attention
    return {"calls": calls, "out": out.detach(),
            "grad": {n: p.grad.clone() for n, p in model.named_parameters()}}
