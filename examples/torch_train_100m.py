"""End-to-end run of the PyTorch port: train a small LM for a few
hundred steps with the fault-tolerant trainer (checkpoint/restart,
straggler accounting, deterministic resumable data).

The counterpart of ``examples/train_100m.py``.  By default a
width-reduced mamba2 runs on the card; ``--full`` trains the published
130M config (bf16, remat, its SSD scan and gradient through K5 and K5b),
``--arch tinyllama-1.1b --full`` the 1.1B attention model (K3 and K3b).
``--device cpu`` runs the plain PyTorch versions on the host.

    PYTHONPATH=src python examples/torch_train_100m.py --steps 300
    PYTHONPATH=src python examples/torch_train_100m.py --full --seq 1024 --steps 100
"""
import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.data import LMDataConfig, LMDataset
from repro_torch.models import LM
from repro_torch.training import OptimizerConfig, Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true", help="use the published config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="checkpoints/torch_train_100m")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full:
        cfg = dataclasses.replace(
            cfg.reduced(), name=cfg.name + "-demo", d_model=128,
            num_layers=min(cfg.num_layers, 6), vocab_size=512,
        )
    model = LM(cfg)
    print(f"arch={cfg.name} params={model.num_params():,}")

    ds = LMDataset(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, kind="markov"))
    trainer = Trainer(
        model, ds,
        opt_cfg=OptimizerConfig(learning_rate=3e-3, warmup_steps=20, total_steps=args.steps),
        cfg=TrainerConfig(total_steps=args.steps, checkpoint_every=100,
                          checkpoint_dir=args.ckpt_dir, log_every=20),
        device=args.device,
    )
    step, params, opt, summary = trainer.train()
    print(f"finished at step {step}; restarts={summary['restarts']} "
          f"stragglers={summary['stragglers']}")
    print("loss trajectory:", [round(loss, 3) for loss in summary["losses"]])
    print("entropy floor:", round(ds.entropy_floor(), 3))


if __name__ == "__main__":
    main()
