"""Compare two source trees of the port on one card, in one run.

Each tree is a directory holding ``chip_smoke.py`` and ``src/`` (a
checkout, or ``git archive`` of a commit unpacked).  Every tree runs in
a child process of its own, in the order given, so that a list such as
``parent change change parent`` spreads the card's and the host's drift
over both.

  smoke   runs each tree's ``chip_smoke.py`` and stamps the moment each
          phase header (a line starting ``[N]``) appears: the seconds of
          every phase, the whole run's and its exit code.  Each run's
          output goes to ``--out/<i>_<tree name>.log``.
  decode  times the eager decode step (the kernels, no CUDA graph) of
          the tree's ``repro_torch`` at full width with random weights:
          tinyllama-1.1b (22 layers) and mamba2-130m (24 layers), batch 1,
          a 128-token prompt, 200 steps after 8 warm-up steps.
          ``host_ms`` is the median time to issue one step (no
          synchronisation inside the step), ``cpu_ms`` the issuing
          thread's CPU time for it (blind to time the thread spends
          descheduled), ``step_ms`` the median step with the card
          synchronised after it.  At batch 1 the card waits on the host,
          so all three read the host's time for a step.
  kernels runs K3 (causal, bf16 and f32, head dims 64 and 256, a
          window), K3b (bf16 and f32: tinyllama's shape, 40 over 8 at
          head dim 128 with a window, head dim 256 with one head group
          and with several) and K5 and K5b (mamba2-130m's width, one
          group: B=8, S=1024, H=24, P=64, N=128, chunk 128) of the tree
          on inputs made from fixed seeds, through the wrappers both
          trees share, and saves their outputs to ``--out/<i>_<tree
          name>.pt`` (about 1 GB a tree: keep ``--out`` out of the
          returned directory); then times K5, K5b and the f32 instances
          of K3 and K3b (tinyllama's shape) with the tree's
          ``chip_smoke.device_ms`` (the kernels' device time under
          torch.profiler).  Each tree's line says whether every output is
          bit-identical to the first tree's, and whether every output but
          the f32 ones is (``bf16_and_ssd_bit_identical``): a tree that
          changed only the f32 instances keeps the rest bit for bit.

Each prints one JSON object per tree and, last, the card's name and power
limit.  Usage, from the repository root on a machine with a card:

  python3 tools/ab_trees.py decode scratch_checkout/parent . . scratch_checkout/parent
  python3 tools/ab_trees.py smoke --out chiprun_out/ab scratch_checkout/parent .
  python3 tools/ab_trees.py kernels --out build/ab scratch_checkout/parent . . \
      scratch_checkout/parent
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

PHASE = re.compile(r"^\[(\d+[a-z]?)\]")
DECODE_ARCHS = (("tinyllama-1.1b", 22), ("mamba2-130m", 24))
STEPS = 200


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def smoke(tree: Path, log: Path) -> dict:
    """One run of ``tree``'s chip_smoke.py: {"phases": {name: s}, "total_s", "rc"}."""
    t0 = time.perf_counter()
    marks: list[tuple[str, float]] = []
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=tree,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            f.write(line)
            m = PHASE.match(line)
            if m:
                marks.append((m.group(1), time.perf_counter() - t0))
        rc = proc.wait()
    total = time.perf_counter() - t0
    ends = [t for _, t in marks[1:]] + [total]
    return {"tree": str(tree), "rc": rc, "total_s": round(total, 3),
            "phases": {name: round(end - start, 3)
                       for (name, start), end in zip(marks, ends)}}


def decode_one() -> dict:
    """The eager decode step of the ``repro_torch`` on ``sys.path``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import LM

    out = {}
    for arch, layers in DECODE_ARCHS:
        cfg = get_config(arch)
        assert cfg.num_layers == layers, (arch, cfg.num_layers)
        model = LM(cfg)
        params = model.init(0, device="cuda")
        gen = torch.Generator().manual_seed(0)
        prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen).to("cuda")
        with torch.no_grad():
            logits, cache = model.prefill(params, prompt, max_len=128 + 8 + STEPS)
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
            host, cpu, step = [], [], []
            for i in range(8 + STEPS):
                torch.cuda.synchronize()
                c0, t0 = time.thread_time(), time.perf_counter()
                logits, cache = model.decode_step(params, cache, tok)
                c1, t1 = time.thread_time(), time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if i >= 8:
                    host.append((t1 - t0) * 1e3)
                    cpu.append((c1 - c0) * 1e3)
                    step.append((t2 - t0) * 1e3)
                tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        out[arch] = {name: {"median": statistics.median(v), "min": min(v)}
                     for name, v in (("host_ms", host), ("cpu_ms", cpu), ("step_ms", step))}
        del params, cache
        torch.cuda.empty_cache()
    return out


# K3's causal cases of ``kernels``: (B, Sq, Skv, Hq, Hkv, D, window, dtype).
K3_CASES = ((8, 1024, 1024, 32, 4, 64, 0, "bfloat16"), (2, 1024, 1024, 16, 16, 256, 0, "bfloat16"),
            (1, 1536, 1536, 8, 4, 256, 1024, "bfloat16"), (2, 37, 300, 8, 2, 64, 0, "bfloat16"),
            (2, 1024, 1024, 32, 4, 64, 0, "float32"), (1, 130, 130, 4, 2, 256, 32, "float32"))
# K3b's cases of ``kernels`` (causal): (B, S, Hq, Hkv, D, window, dtype).
K3B_CASES = ((8, 1024, 32, 4, 64, 0, "bfloat16"), (2, 300, 40, 8, 128, 64, "bfloat16"),
             (2, 1024, 16, 16, 256, 0, "bfloat16"), (2, 1024, 16, 1, 256, 0, "bfloat16"),
             (2, 1024, 32, 4, 64, 0, "float32"), (1, 300, 16, 1, 256, 100, "float32"))
SSD_SHAPE = (8, 1024, 24, 64, 128, 128)  # B, S, H, P, N, chunk


def kernels_one(out: Path) -> dict:
    """K3, K5 and K5b of the ``repro_torch`` on ``sys.path`` on seeded
    inputs: their outputs saved to ``out``, K5's and K5b's device ms."""
    import torch

    from chip_smoke import device_ms
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    saved = {}
    for b, sq, skv, hq, hkv, d, window, dtype in K3_CASES:
        q = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(getattr(torch, dtype))
        k, v = (torch.randn((b, skv, hkv, d), generator=gen, device="cuda").to(q.dtype)
                for _ in range(2))
        o, lse = flash_ops.flash_attention(q, k, v, window=window, return_lse=True)
        key = f"k3 {b} {sq} {skv} {hq} {hkv} {d} {window} {dtype}"
        saved[key], saved[key + " lse"] = o.cpu(), lse.cpu()
    for b, s, hq, hkv, d, window, dtype in K3B_CASES:
        q, do = (torch.randn((b, s, hq, d), generator=gen, device="cuda").to(getattr(torch, dtype))
                 for _ in range(2))
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(q.dtype)
                for _ in range(2))
        o, lse = flash_ops.flash_attention(q, k, v, window=window, return_lse=True)
        grads = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, window=window)
        key = f"k3b {b} {s} {hq} {hkv} {d} {window} {dtype}"
        saved.update({f"{key} {name}": g.cpu() for name, g in zip(("dq", "dk", "dv"), grads)})
    timed = {}
    q, do = (torch.randn((8, 1024, 32, 64), generator=gen, device="cuda") for _ in range(2))
    k, v = (torch.randn((8, 1024, 4, 64), generator=gen, device="cuda") for _ in range(2))
    o, lse = flash_ops.flash_attention(q, k, v, return_lse=True)
    timed["k3_f32_ms"] = device_ms(lambda: flash_ops.flash_attention(q, k, v), "flash_attention",
                                   iters=10)
    timed["k3b_f32_ms"] = device_ms(lambda: flash_ops.flash_attention_bwd(q, k, v, o, do, lse),
                                    "flash_attention_bwd", iters=5)
    del q, k, v, do, o, lse
    b, s, h, p, n, chunk = SSD_SHAPE
    xdt = torch.randn((b, s, h, p), generator=gen, device="cuda") * 0.5
    dA = -torch.rand((b, s, h), generator=gen, device="cuda") * 0.3
    bm, cm = (torch.randn((b, s, n), generator=gen, device="cuda") * 0.3 for _ in range(2))
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
    y, final, cum, entering = ssd_ops.ssd_chunk_scan_saving(xdt, dA, bm, cm, chunk)
    grads = ssd_ops.ssd_chunk_bwd(xdt, bm, cm, dy, cum, entering, chunk)
    saved.update({"k5 y": y.cpu(), "k5 final": final.cpu(),
                  **{f"k5b {name}": g.cpu() for name, g in zip(("dxdt", "dda", "dbm", "dcm"),
                                                                 grads)}})
    torch.save(saved, out)
    return {**timed, "ssd_ms": device_ms(lambda: ssd_ops.ssd_chunk_scan(xdt, dA, bm, cm, chunk),
                                "ssd_chunk_scan", iters=20),
            "ssd_bwd_ms": device_ms(lambda: ssd_ops.ssd_chunk_bwd(xdt, bm, cm, dy, cum, entering,
                                                                  chunk),
                                    "ssd_chunk_bwd", iters=10)}


def same_as(first: Path, other: Path) -> dict:
    """{output: bit-identical} of two ``kernels`` runs' saved outputs."""
    import torch

    a, b = torch.load(first), torch.load(other)
    return {k: bool(k in b and torch.equal(a[k], b[k])) for k in a}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("what", choices=["smoke", "decode", "decode-one", "kernels", "kernels-one"])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/ab"),
                    help="directory of the smoke runs' logs")
    args = ap.parse_intermixed_args(argv)
    if args.what == "decode-one":
        print(json.dumps(decode_one()))
        return 0
    if args.what == "kernels-one":
        print(json.dumps(kernels_one(args.out)))
        return 0
    rc = 0
    args.out.mkdir(parents=True, exist_ok=True)
    saved = []
    for i, tree in enumerate(args.trees):
        tree = tree.resolve()
        if args.what == "smoke":
            res = smoke(tree, args.out / f"{i}_{tree.name}.log")
        else:
            env = dict(os.environ, PYTHONPATH=f"{tree / 'src'}{os.pathsep}{tree}")
            cmd = [sys.executable, str(Path(__file__).resolve()), f"{args.what}-one"]
            if args.what == "kernels":
                saved.append(args.out.resolve() / f"{i}_{tree.name}.pt")
                cmd += ["--out", str(saved[-1])]
            proc = subprocess.run(cmd, env=env, cwd=tree, capture_output=True, text=True)
            lines = proc.stdout.strip().splitlines()
            res = {"tree": str(tree), "rc": proc.returncode}
            if proc.returncode == 0 and lines:
                res.update(json.loads(lines[-1]))
                if args.what == "kernels":
                    same = same_as(saved[0], saved[-1])
                    res["bit_identical_to_first"] = all(same.values())
                    res["bf16_and_ssd_bit_identical"] = all(
                        v for k, v in same.items() if "float32" not in k)
                    res["differing"] = sorted(k for k, v in same.items() if not v)
            else:
                res["error"] = proc.stderr[-2000:]
        rc = rc or res["rc"]
        print(json.dumps(res), flush=True)
    print(f"card: {card_line()}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
