"""Quality-gate runner: train all four stages -> flagship run -> QUALITY JSON
(port of audio_classification_tpu/cli/quality_gate.py).

Emits the quality artifact: the reference's headline quality metrics --
target_hit_rate_segments, PIT SI-SDR / SI-SDRi (reference run log:
todo.md:4-11) -- plus per-record CER on the synthetic world, with explicit
pass gates (hit rate >= 0.9, CER <= 0.2). Runs on the card unless
``--provider cpu``.

    python -m audio_classification_tpu_torch.cli.quality_gate \\
        --out QUALITY_torch_h100.json

Full scale (QUALITY_torch_h100.json at the repo root) took 249 s end to end
on one NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi name, power.limit): 238 s
of training (separator 39.9, OSD 10.0, speaker 9.6, ASR 178.6) and a 0.1 s
warm pipeline pass. --steps-scale 0.01 is the plumbing smoke.
"""
from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="QUALITY.json", help="Artifact path")
    p.add_argument("--steps-scale", type=float, default=1.0,
                   help="Scale every stage's training step budget")
    p.add_argument("--scenes", type=int, default=6,
                   help="Held-out evaluation scenes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-seed", type=int, default=424242)
    p.add_argument("--hit-gate", type=float, default=0.9)
    p.add_argument("--cer-gate", type=float, default=0.2)
    p.add_argument("--no-gate-exit", action="store_true",
                   help="Always exit 0 (report-only mode)")
    p.add_argument("--ckpt-dir", default=None,
                   help="Save the trained world pack here (the port's model-pack directory)")
    p.add_argument("--reuse-ckpt", action="store_true",
                   help="Skip training when --ckpt-dir already exists")
    p.add_argument("--provider", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..engine.runtime import resolve_device
    from ..parallel.launch import is_writer, world_mesh
    from ..pipelines.quality_gate import run_quality_gate, write_quality_json

    device = resolve_device(args.provider)
    mesh = world_mesh(device)  # data-parallel over the world, as JAX over every device
    device = mesh.device if mesh is not None else device
    m = run_quality_gate(steps_scale=args.steps_scale, n_scenes=args.scenes,
                         seed=args.seed, eval_seed=args.eval_seed,
                         ckpt_dir=args.ckpt_dir, reuse_ckpt=args.reuse_ckpt,
                         device=device, mesh=mesh)
    if not is_writer():  # a rank of the world: rank 0 writes
        return m
    artifact = write_quality_json(m, args.out, hit_gate=args.hit_gate,
                                  cer_gate=args.cer_gate, device=device)
    print(f"quality gate: {'OK' if artifact['quality_ok'] else 'FAILED'} "
          f"-> {args.out}")
    if not artifact["quality_ok"] and not args.no_gate_exit:
        sys.exit(1)
    return artifact


if __name__ == "__main__":
    main()
