"""Training launcher: mirror of :mod:`repro.launch.train`.

Builds the model with seeded float32 master weights, trains it on the
synthetic pipeline in the reference's stacked parameter tree, restores
the newest complete checkpoint of ``--ckpt-dir`` and reports slow steps.
``--device`` is ``cuda`` by default and refuses without a card.

Examples::

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 4 --batch 4 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --steps 50 --optimizer soap_givens
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.sequence import resolve_device
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import build_model
from repro_torch.models.zoo import stack_params
from repro_torch.optim import AdamW, SoapGivens, warmup_cosine
from repro_torch.train import StragglerMonitor, TrainLoop, make_train_step
from repro_torch.tree import leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving tiny config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adamw_q8", "soap_givens"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; refused without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(0))
    params = stack_params(cfg, model.params())
    n_params = sum(x.numel() for x in leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={device}")

    sched = warmup_cosine(args.lr, warmup=args.steps // 10 + 1,
                          total=args.steps)
    opt = {
        "adamw": AdamW(lr=sched),
        "adamw_q8": AdamW(lr=sched, quantized=True),
        "soap_givens": SoapGivens(lr=sched),
    }[args.optimizer]

    step = make_train_step(model, cfg, opt, remat=False,
                           grad_accum=args.grad_accum)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))
    mon = StragglerMonitor()
    mon.on_straggler = lambda s, dt, med: print(
        f"  [straggler] step {s}: {dt:.2f}s vs median {med:.2f}s")

    loop = TrainLoop(train_step=step, params=params,
                     opt_state=opt.init(params), data_iter=data,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     monitor=mon, device=device)
    start = loop.maybe_restore()
    if start:
        print(f"restored checkpoint at step {start}")
    hist = loop.run(args.steps)
    for i in range(0, len(hist["loss"]), args.log_every):
        print(f"step {start + i + 1:5d}  loss {hist['loss'][i]:.4f}  "
              f"{hist['time'][i]*1e3:.0f} ms")
    print(f"final loss {hist['loss'][-1]:.4f}")
    return hist


if __name__ == "__main__":
    main()
