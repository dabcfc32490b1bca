"""End-to-end example on the PyTorch/CUDA port: train a ~100M-parameter LM
for a few hundred steps, with checkpoints and resume.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--device cpu]

Runs on the card unless ``--device cpu`` is given (f32 weights either way,
as the reference's example). A second run with the same ``--ckpt-dir``
resumes from its latest checkpoint.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.data import synthetic as S
from repro_torch.models.transformer import LMConfig, init_lm, lm_loss
from repro_torch.train.optimizer import OptConfig, opt_init, opt_update
from repro_torch.train.trainer import (Prefetcher, TrainerConfig, to_device,
                                       train_loop)

# ~100M params: 12L × d512 × heads 8 × ffn 2048, vocab 32k (llama-shaped)
CFG = LMConfig(
    name="lm-100m", n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
    head_dim=64, d_ff=2048, vocab=32768, tied_embed=True, act="silu",
    dtype=torch.float32)
OPT = OptConfig(name="adamw", lr=1e-3, warmup_steps=20)
CKPT_EVERY = 50


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32

    print(f"params: {CFG.param_count()/1e6:.0f}M")
    model = init_lm(CFG, torch.Generator(device).manual_seed(0), device)
    opt_state = opt_init(model, OPT)

    def step_fn(model, opt_state, batch):
        names, params = zip(*model.named_parameters())
        loss = lm_loss(model, batch)
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        opt_update(model, grads, opt_state, OPT)
        return model, opt_state, {"loss": loss.detach()}

    def batches():
        step = 0
        while True:
            yield S.lm_batch(0, step, args.batch, args.seq, CFG.vocab)
            step += 1

    out = train_loop(
        step_fn, model, opt_state,
        Prefetcher(batches(), lambda b: to_device(b, device)),
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=CKPT_EVERY, log_every=10),
    )
    first, last = out["losses"][0], out["losses"][-1]
    print(f"loss {first:.3f} -> {last:.3f} over {len(out['losses'])} steps "
          f"(resumable from {args.ckpt_dir})")
    return out


if __name__ == "__main__":
    main()
