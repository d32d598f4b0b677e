"""``dryrun_multichip(n)``: the mesh paths' smoke check (the port of the JAX
package's ``dryrun_multichip``). Over a world of n ranks (torchrun, one rank
per card; gloo ranks on the CPU in the tests) or, without a process group,
over n entries on one device, it runs:

- one Conv-TasNet train step at model axis 2 (DP x TP), finite loss;
- the SenseVoice encoder with ring attention over the data axis against its
  dense path on the same weights;
- the TP engine's ``separate`` against the meshless engine's;
- the time-sharded separator on the trained weights against the dense
  masked forward.

    torchrun --nproc-per-node 2 -m audio_classification_tpu_torch.parallel.dryrun 2
"""
from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> Dict[str, float]:
    """-> the errors and the loss it checked; raises AssertionError on a
    mismatch. ``device`` names the device of every entry (default: the
    card; under a process group the rank's own card)."""
    from ..engine.runtime import resolve_device
    from ..models.asr.sensevoice import SenseVoiceConfig, SenseVoiceEncoder
    from ..models.convtasnet import ConvTasNet, ConvTasNetConfig
    from ..parallel.launch import init_distributed, launched
    from ..train.trainer import SeparatorTrainer, flax_init_
    from .mesh import make_mesh
    from .sp_convtasnet import sp_separate

    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    dev = resolve_device(device)
    if launched():
        init_distributed(dev.type)
    mesh = make_mesh(n_devices, model_axis=model_axis, devices=[dev] * n_devices)
    dev = mesh.device
    data = mesh.shape["data"]
    out: Dict[str, float] = {}

    cfg = ConvTasNetConfig(n_src=3, enc_dim=64, enc_kernel=16, bottleneck=32, hidden=64,
                           n_blocks=2, n_repeats=1)
    trainer = SeparatorTrainer(cfg, mesh=mesh, lr=1e-3, seed=0, device=dev)
    b = max(data, 2)
    b = -(-b // data) * data
    rng = np.random.default_rng(0)
    refs = rng.standard_normal((b, 3, 4000)).astype(np.float32) * 0.3
    loss = trainer.train_step(refs.sum(axis=1), refs, np.ones((b, 4000), np.float32))
    assert np.isfinite(loss), f"non-finite loss from the sharded train step: {loss}"
    out["train_loss"] = float(loss)

    with torch.no_grad():
        sv_cfg = SenseVoiceConfig(vocab_size=12, dim=16, heads=2, layers=2, ffn_mult=2,
                                  conv_kernel=3)
        enc = flax_init_(SenseVoiceEncoder(sv_cfg), 0).to(dev).eval()
        t_seq = 8 * data
        feats = torch.from_numpy(rng.standard_normal(
            (1, t_seq, sv_cfg.lfr_m * sv_cfg.num_mel)).astype(np.float32)).to(dev)
        fmask = torch.arange(t_seq, device=dev)[None, :] < t_seq - 5
        dense = enc(feats, fmask)
        ring = enc(feats, fmask, mesh=mesh, sp_axis="data")
        out["sp_err"] = float((ring - dense).abs().max())
        assert out["sp_err"] < 1e-4, f"sequence-parallel SenseVoice mismatch: {out['sp_err']}"

        if model_axis > 1:
            from ..engine import BucketSpec, ModelPack, StageEngine, tiny_preset

            pack = ModelPack(tiny_preset(), seed=0, device=dev)
            spec = BucketSpec(lengths=(4000,), max_batch=max(4, data))
            wav = (0.3 * rng.standard_normal(4000)).astype(np.float32)
            a = StageEngine(pack, spec).separate([wav], n_src=3)[0]
            c = StageEngine(pack, spec, mesh=mesh).separate([wav], n_src=3)[0]
            out["tp_err"] = float(np.abs(a - c).max())
            assert out["tp_err"] < 2e-4, f"TP serving separate mismatch: {out['tp_err']}"

        model = ConvTasNet(cfg).to(dev).eval()
        model.load_state_dict(trainer.model.state_dict())
        mix = torch.from_numpy((0.3 * rng.standard_normal((1, 8000))).astype(np.float32)).to(dev)
        dense_sep = model(mix, torch.ones_like(mix))
        sp_sep = sp_separate(model, mix, None, mesh)
        out["sp_sep_err"] = float((sp_sep - dense_sep).abs().max()
                                  / (dense_sep.abs().max() + 1e-9))
        assert out["sp_sep_err"] < 1e-4, \
            f"time-sharded separation mismatch: {out['sp_sep_err']}"
    return out


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2))
