"""Multi-rank helpers for the port's distribution tests (no JAX here).

``run_ranks(target, world, *args)`` starts ``world`` processes with
``torch.multiprocessing``'s spawn context, each joining a gloo group over a
free ``tcp://localhost`` port with its rank passed explicitly, runs
``target(rank, *args)`` there and waits at most ``timeout`` seconds for all
of them.  No process group is ever made in the calling (pytest) process.
The workers below write their results with ``torch.save`` into the
directory they are given; the tests read them back.
"""
from __future__ import annotations

import socket
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, target, args, backend="gloo"):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group

    torch.set_num_threads(1)
    init_group(backend, rank=rank, world_size=world, port=port)
    try:
        target(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(target, world: int, *args, timeout: float = JOIN_TIMEOUT_S,
              backend: str = "gloo") -> float:
    """Run ``target(rank, *args)`` on ``world`` ranks of a ``backend``
    group (gloo; nccl for ranks on cards); returns the seconds taken.
    Raises if a rank fails or the join times out."""
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, target, args, backend))
             for r in range(world)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(0.0, timeout - (time.monotonic() - t0)))
        alive = [p for p in procs if p.is_alive()]
        if alive:
            raise TimeoutError(f"{len(alive)} of {world} ranks still running after {timeout} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return time.monotonic() - t0


def _mesh22():
    from repro_torch.launch.mesh import make_debug_mesh

    return make_debug_mesh(2, 2, device="cpu")


def _save(out_dir, rank, obj):
    torch.save(obj, Path(out_dir) / f"rank{rank}.pt")


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------


def debug_mesh_worker(rank, out_dir):
    m = _mesh22()
    _save(out_dir, rank, {"shape": list(m.shape), "names": list(m.mesh_dim_names),
                          "coord": list(m.get_coordinate())})


def compressed_psum_worker(rank, out_dir, shards: np.ndarray):
    """Rank r sums shard r over the world group with ``compressed_psum``."""
    import torch.distributed as dist

    from repro_torch.training.compression import compressed_psum

    x = torch.from_numpy(shards[rank].copy())
    _save(out_dir, rank, compressed_psum(x, dist.group.WORLD))


def attention_worker(rank, out_dir, q, k, v, kw):
    """``attention_prefill_sharded`` on a 2 x 2 mesh; every rank saves the
    full output."""
    from repro_torch.sharding.rules import distribute
    from repro_torch.models.layers import attention_prefill_sharded

    mesh = _mesh22()
    B, S = q.shape[:2]
    pos = torch.arange(S)[None].expand(B, S).contiguous()
    qd = distribute(torch.from_numpy(q), (("data",), "model", None, None), mesh)
    kd = distribute(torch.from_numpy(k), (("data",), None, None, None), mesh)
    vd = distribute(torch.from_numpy(v), (("data",), None, None, None), mesh)
    out = attention_prefill_sharded(qd, kd, vd, q_positions=pos, kv_positions=pos, mesh=mesh, **kw)
    _save(out_dir, rank, out.full_tensor())


def moe_worker(rank, out_dir, arch, params_np, x_np, strategy):
    """``moe_apply_sharded`` of a reduced config's layer-0 MoE on a 2 x 2
    mesh, laid out by the parameter rules; every rank saves (out, aux)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.sharding.rules import distribute
    from repro_torch.models.moe import moe_apply_sharded
    from repro_torch.params import params_from_jax
    from repro_torch.sharding.rules import param_pspecs

    mesh = _mesh22()
    cfg = reduced(get_config(arch))
    p = params_from_jax(params_np, "cpu")
    specs = param_pspecs(cfg, {"layers": {"moe": p}}, mesh)["layers"]["moe"]
    pd = {k: distribute(t, specs[k], mesh) for k, t in p.items()}
    x_spec = (("data", "model"), None) if strategy == "a2a" else (("data",), None)
    xd = distribute(torch.from_numpy(x_np), x_spec, mesh)
    out, aux = moe_apply_sharded(pd, xd, cfg, mesh, strategy=strategy)
    _save(out_dir, rank, (out.full_tensor(), aux.full_tensor()))


def train_worker(rank, out_dir, arch, masters_np, batches_np, steps, compute_dtype,
                 moe_strategy="auto"):
    """``steps`` sharded train steps of a reduced config on a 2 x 2 mesh
    from the given f32 masters, the compute leaves in ``compute_dtype``
    (the step's ``COMPUTE_DTYPE``, set in this process only); rank 0 saves
    the losses and grad norms."""
    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.launch import steps as st
    from repro_torch.params import params_from_jax
    from repro_torch.sharding.rules import full
    from repro_torch.training import step as train_step
    from repro_torch.training.optimizer import init_opt_state

    train_step.COMPUTE_DTYPE = getattr(torch, compute_dtype)
    mesh = _mesh22()
    cfg = reduced(get_config(arch))
    B, S = batches_np[0]["tokens"].shape
    cell = st.build_cell(arch, "train_t", mesh, cfg=cfg, moe_strategy=moe_strategy,
                         shape=ShapeSpec("train_t", seq_len=S, global_batch=B, kind="train"))
    masters = params_from_jax(masters_np, "cpu")
    params = st.distribute_argument(cell, "params", masters)
    opt_state = st.distribute_argument(cell, "opt_state", init_opt_state(masters, cell.opt_cfg))
    rec = []
    for i in range(steps):
        batch = st.distribute_argument(
            cell, "batch", {k: torch.from_numpy(v) for k, v in batches_np[i].items()})
        params, opt_state, m = st.run_cell(cell, (params, opt_state, batch))
        rec.append({k: float(full(v)) for k, v in m.items()})
    if rank == 0:
        _save(out_dir, rank, rec)


def attn_mode_worker(rank, out_dir, masters_np, batch_np, mode):
    """Reduced qwen3's f32 loss and grads on a 2 x 2 mesh with the attention
    sharding ``mode`` (``layers.set_attn_sharding``); rank 0 saves the loss
    and the grads gathered whole."""
    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.launch import steps as st
    from repro_torch.models import layers
    from repro_torch.params import params_from_jax
    from repro_torch.sharding.rules import full
    from repro_torch.training import step as train_step
    from repro_torch.training.tree import map_tree
    from torch.distributed.tensor.experimental import implicit_replication

    train_step.COMPUTE_DTYPE = torch.float32
    layers.set_attn_sharding(mode)
    mesh = _mesh22()
    cfg = reduced(get_config("qwen3-1.7b"))
    B, S = batch_np["tokens"].shape
    cell = st.build_cell("qwen3-1.7b", "train_t", mesh, cfg=cfg,
                         shape=ShapeSpec("train_t", seq_len=S, global_batch=B, kind="train"))
    params = st.distribute_argument(cell, "params", params_from_jax(masters_np, "cpu"))
    batch = st.distribute_argument(cell, "batch",
                                   {k: torch.from_numpy(v) for k, v in batch_np.items()})
    with implicit_replication():
        loss, grads = train_step.loss_and_grads(cell.bundle, params, batch)
    loss, grads = float(full(loss)), map_tree(full, grads)  # collectives on every rank
    if rank == 0:
        _save(out_dir, rank, (loss, grads))


def trainer_worker(rank, out_dir, masters_np, steps):
    """``Trainer(mesh=)`` on reduced qwen3 over a 2 x 2 mesh from the given
    masters: ``steps`` steps with a checkpoint at ``steps - 2``, a second
    trainer resumed from it onto its placements for the last two, and the
    first re-meshed onto 1 x 4 for one more; rank 0 saves the losses."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.params import params_from_jax
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import Trainer
    from repro_torch.training.tree import map_tree

    mesh = _mesh22()
    cfg = reduced(get_config("qwen3-1.7b"))
    ckpt = Path(out_dir) / "ckpt"

    def trainer():
        tr = Trainer(build_model(cfg, device="cpu", mesh=mesh), mesh=mesh,
                     data_cfg=DataConfig(cfg.vocab_size, 32, 4),
                     opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=2), ckpt_dir=ckpt,
                     ckpt_every=steps - 2, async_ckpt=False)
        full_masters = params_from_jax(masters_np, "cpu")
        tr.params = tr._distribute(full_masters, tr._p_specs)
        tr.opt_state = tr._distribute(init_opt_state(full_masters, tr.opt_cfg), tr._o_specs)
        return tr

    a = trainer()
    a.run(steps, log_every=0)
    b = trainer()
    assert b.resume() and b.step == steps - 2
    b.run(steps, log_every=0)
    a.remesh(make_debug_mesh(1, 4, device="cpu"))
    a.run(steps + 1, log_every=0)
    placements = str(map_tree(lambda t: t.placements, a.params)["layers"]["attn"]["wq"])
    if rank == 0:
        _save(out_dir, rank, {"a": [m["loss"] for m in a.metrics],
                              "b": [m["loss"] for m in b.metrics], "placements": placements})


def card_worker(rank, out_dir):
    """One rank of a one-rank NCCL group on the card, a 1 x 1 mesh, reduced
    configs: the sharded prefill (and its K5 launches), three sharded train
    steps of qwen3, ``compressed_psum`` and the sharded MoE strategies, each
    beside its unsharded counterpart on the card; saves the numbers."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.moe import moe_apply_local, moe_apply_sharded, moe_init
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.rules import distribute, full
    from repro_torch.training.compression import compress_roundtrip, compressed_psum
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import Trainer
    from repro_torch.training.tree import map_tree

    mesh = make_debug_mesh(1, 1)
    res = {}
    cfg = reduced(get_config("qwen3-1.7b"))
    b = build_model(cfg)
    params = b.init_params(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).cuda()
    cell = st.build_cell("qwen3-1.7b", "prefill_t", mesh, cfg=cfg,
                         shape=ShapeSpec("prefill_t", 64, 2, "prefill"))
    n0 = fa.flash_attention.launches
    logits, _ = st.run_cell(cell, (st.distribute_argument(cell, "params", params),
                                   st.distribute_argument(cell, "batch", {"tokens": tokens})))
    res["prefill_k5"] = fa.flash_attention.launches - n0
    res["prefill"] = (full(logits).cpu(), b.prefill_fn(params, {"tokens": tokens}, 64)[0].cpu())

    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2)
    cell = st.build_cell("qwen3-1.7b", "train_t", mesh, cfg=cfg, opt_cfg=opt_cfg,
                         shape=ShapeSpec("train_t", 32, 4, "train"))
    masters = map_tree(lambda t: t.float(), params)
    p = st.distribute_argument(cell, "params", masters)
    o = st.distribute_argument(cell, "opt_state", init_opt_state(masters, opt_cfg))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4))
    got = []
    for i in range(3):
        batch = st.distribute_argument(
            cell, "batch", {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(i).items()})
        p, o, m = st.run_cell(cell, (p, o, batch))
        got.append((float(full(m["loss"])), float(full(m["grad_norm"]))))
    tr = Trainer(build_model(cfg), data_cfg=DataConfig(cfg.vocab_size, 32, 4), opt_cfg=opt_cfg)
    res["train"] = (got, [(m["loss"], m["grad_norm"]) for m in tr.run(3, log_every=0)])

    x = torch.randn((64, 1000), generator=torch.Generator().manual_seed(2)).cuda()
    res["psum"] = bool(torch.equal(compressed_psum(x, mesh.get_group("data")),
                                   compress_roundtrip(x)))

    mcfg = reduced(get_config("grok-1-314b"))
    mp_ = moe_init(torch.Generator(device="cuda").manual_seed(0), mcfg)
    xm = torch.randn((64, mcfg.d_model), generator=torch.Generator().manual_seed(3)).cuda().to(
        torch.bfloat16)
    want, aux = moe_apply_local(mp_, xm, mcfg)
    rep = lambda t: distribute(t, (None,) * t.ndim, mesh)
    res["moe"] = {}
    with implicit_replication(), torch.no_grad():
        for strategy in ("ep", "tp", "a2a"):
            out, a = moe_apply_sharded({k: rep(v) for k, v in mp_.items()}, rep(xm), mcfg, mesh,
                                       strategy=strategy)
            res["moe"][strategy] = (float((out.full_tensor().float() - want.float()).abs().max()),
                                    abs(float(a.full_tensor()) - float(aux)))
    _save(out_dir, rank, res)
