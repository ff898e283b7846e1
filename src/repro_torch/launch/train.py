"""Training launcher, on one device.

Trains the same code paths at whatever size fits the card.  The LM archs
take the reduced smoke configs with ``--smoke``, ``full_config()``
without, with the reference's fault-tolerance stack: checkpoint/resume
(the reference's on-disk layout, so either package resumes the other's),
async saves, straggler monitoring and the resumable synthetic token
stream.  The GNN archs train their smoke config full-batch on a
kron-``--scale`` graph (edge factor 8) with community-structured node
features; DIN trains its smoke config on the synthetic click stream::

    python -m repro_torch.launch.train --arch qwen2-1.5b --smoke --steps 20
    python -m repro_torch.launch.train --arch qwen2-1.5b --smoke --steps 20 \\
        --ckpt /tmp/qwen_ckpt --ckpt-every 10          # kill, rerun: resumes
    python -m repro_torch.launch.train --arch qwen2-1.5b --smoke --steps 20 --device cpu
    python -m repro_torch.launch.train --arch gcn-cora --steps 30
    python -m repro_torch.launch.train --arch din --steps 10 --device cpu

``--device`` defaults to ``cuda``; without a card the CLI stops unless
given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.base import optimizer_step
from repro_torch.configs.gnn_common import _ce_loss
from repro_torch.data import TokenPipeline, din_batch, graph_node_features
from repro_torch.distributed import StragglerMonitor
from repro_torch.graphs import kronecker_rmat
from repro_torch.optim import OptState, adamw, constant, cosine_with_warmup


def state_tree(params, opt_state: OptState) -> dict:
    """The train state in the reference's layout: ``{"params", "opt"}``
    with ``layers`` stacked, as numpy arrays (checkpoint keys
    ``params/layers/wq``, ``opt/.step``, ``opt/.mu/layers/wq`` …)."""
    from repro_torch.models import transformer as tfm

    return {"params": tfm.params_to_numpy(params),
            "opt": OptState(step=opt_state.step.cpu().numpy(),
                            mu=tfm.params_to_numpy(opt_state.mu),
                            nu=tfm.params_to_numpy(opt_state.nu))}


def load_state(params, tree: dict, device) -> OptState:
    """Copy a restored :func:`state_tree` into ``params``; returns the
    optimizer state on ``device``."""
    from repro_torch.models import transformer as tfm

    tfm.load_numpy_(tfm.param_tree(params), tree["params"])
    opt = tree["opt"]
    return OptState(step=torch.as_tensor(opt.step, dtype=torch.int32).to(device),
                    mu=tfm.tensors_from_numpy(opt.mu, device),
                    nu=tfm.tensors_from_numpy(opt.nu, device))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _train_lm(mod, args, dev: torch.device) -> float:
    from repro_torch.configs.lm_common import make_lm_train_step
    from repro_torch.models import transformer as tfm

    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    params = tfm.init_params(cfg, args.seed, dev)
    lr = constant(1e-3) if args.smoke else cosine_with_warmup(3e-4, 2000, args.steps)
    step_fn, opt_init = make_lm_train_step(cfg, accum=1, lr=lr)
    opt_state = opt_init(params)
    pipe = TokenPipeline(args.batch, args.seq, cfg.vocab_size, seed=args.seed)
    mgr = CheckpointManager(args.ckpt, keep=3) if args.ckpt else None
    start = 0
    if mgr is not None:
        restored = mgr.restore_latest(state_tree(params, opt_state))
        if restored is not None:
            tree, start, extra = restored
            opt_state = load_state(params, tree, dev)
            pipe = TokenPipeline.from_state(args.batch, args.seq, cfg.vocab_size,
                                            extra["data_state"])
            print(f"resumed from step {start}")
    mon = StragglerMonitor()
    loss = float("nan")
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v)[None].to(dev) for k, v in next(pipe).items()}  # accum dim
        mon.start_step()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        _sync(dev)  # the step's device time, not its enqueue
        straggled = mon.end_step()
        loss = float(metrics["loss"])
        if step % args.log_every == 0 or step == args.steps - 1:
            print(
                f"step {step} loss {loss:.4f} "
                f"gnorm {float(metrics['gnorm']):.3f}"
                + (" [straggler]" if straggled else "")
            )
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state_tree(params, opt_state), {"data_state": pipe.state()})
    if mgr is not None:
        mgr.save(args.steps, state_tree(params, opt_state), {"data_state": pipe.state()})
        mgr.wait()
    return loss


def _train_gnn(mod, args, dev: torch.device) -> float:
    cfg = mod.smoke_config()
    model = mod.MODEL
    edges = kronecker_rmat(max(8, args.scale), edge_factor=8, seed=args.seed)
    n = int(edges.max()) + 1
    feat, labels = graph_node_features(args.seed, n, cfg.d_in, cfg.d_out)
    pos = np.random.default_rng(args.seed).normal(size=(n, 3)).astype(np.float32)
    params = model.init_params(cfg, args.seed, dev)
    opt_init, opt_update = adamw(constant(1e-2), weight_decay=0.0)
    opt_state = opt_init(params)

    step_fn = optimizer_step(
        lambda p, feat, pos, src, dst, labels: _ce_loss(model.apply(p, cfg, feat, pos, src, dst),
                                                        labels), opt_update)
    inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (feat, pos, edges[:, 0], edges[:, 1], labels)]
    loss_v = float("nan")
    for step in range(args.steps):
        params, opt_state, metrics = step_fn(params, opt_state, *inputs)
        _sync(dev)
        loss_v = float(metrics["loss"])
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step} loss {loss_v:.4f}")
    return loss_v


def _train_din(mod, args, dev: torch.device) -> float:
    from repro_torch.models.recsys import din as din_model

    cfg = mod.smoke_config()
    params = din_model.init_params(cfg, args.seed, dev)
    step_fn, opt_init = mod._train_step(cfg)
    opt_state = opt_init(params)
    loss_v = float("nan")
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in din_batch(
            args.seed, step, args.batch, cfg.seq_len, cfg.n_items, cfg.n_cates
        ).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        _sync(dev)
        loss_v = float(metrics["loss"])
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step} loss {loss_v:.4f}")
    return loss_v


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--scale", type=int, default=9, help="graph scale for GNN archs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) or cpu; without a card, cuda stops the run")
    args = ap.parse_args()
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from None
    mod = get_arch(args.arch)
    t0 = time.time()
    train = {"lm": _train_lm, "gnn": _train_gnn, "recsys": _train_din}[mod.FAMILY]
    loss = train(mod, args, dev)
    print(f"done: final loss {loss:.4f} in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
