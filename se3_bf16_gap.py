"""How far `se3_transformer_equihnns`' bfloat16 gradients at the recipe
(hidden 256, the bf16 recipe path of `chip_smoke.py`) lie from float32,
and why: the encoder's parameter gradients under `chip_smoke.py`'s smooth
encoder loss, at its weights (seed 3), on the first molecules of its batch.

    python3 se3_bf16_gap.py [--molecules 4] [--query-scale 1.0] [--card]

Prints, on the CPU (the plain versions of the kernels):
  * each attention softmax's logits: the largest magnitude, the mean range
    of a row and the mean largest probability (a saturated softmax passes
    almost no gradient in float32, and what bfloat16 passes is rounding);
  * the CPU's bfloat16-vs-float32 distance, relative L2 over all
    parameters, then by module.
`--query-scale s` multiplies every attention's query weights (`attn_*.to_q`)
by s first: the logits by s. With `--card` (a CUDA device), also the card's
bfloat16 gradients against the CPU's as a share of that distance, with
kernels J and K, and with their plain bfloat16 versions in their place (the
same function summed in cuBLAS's order).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

import chip_smoke as smoke


def _grads(device, dtype, batch, proj, query_scale, record=None):
    from equihgnn_tpu_torch import create_model

    cfg = dataclasses.replace(smoke.recipe(smoke.SE3_BF16), compute_dtype=dtype)
    model = create_model("se3_transformer_equihnns", num_target=1, device=device, cfg=cfg,
                         generator=torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".to_q." in name:
                p.mul_(query_scale)
    b = batch.to(device)
    softmax = torch.softmax

    def spy(x, dim=-1, **kw):
        p = softmax(x, dim=dim, **kw)
        if record is not None:
            x = x.detach()
            live = x > -1e8  # the masked logits are -1e9
            hi = torch.where(live, x, torch.full_like(x, -torch.inf)).amax(dim)
            lo = torch.where(live, x, torch.full_like(x, torch.inf)).amin(dim)
            rows = torch.isfinite(hi)
            record.append((float(x[live].abs().max()), float((hi - lo)[rows].mean()),
                           float(p.detach().amax(dim)[rows].mean())))
        return p

    torch.softmax = spy
    try:
        loss = torch.sum(model.encode(b)[b.atom_mask] * proj.to(device)[b.atom_mask])
        loss.backward()
    finally:
        torch.softmax = softmax
    return {n: p.grad.cpu() if p.grad is not None else None for n, p in model.named_parameters()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--molecules", type=int, default=4)
    ap.add_argument("--query-scale", type=float, default=1.0)
    ap.add_argument("--card", action="store_true")
    args = ap.parse_args()
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.nn import se3_transformer as se3
    from equihgnn_tpu_torch.ops.kernels.pooled_conv import pooled_conv_plain

    samples = smoke.bench_batch()[0][:args.molecules]
    batch = next(iter_batches(samples, spec_for_samples(samples, len(samples)), with_pos=True,
                              target=0))
    proj = torch.randn(batch.num_atoms, smoke.HIDDEN, generator=torch.Generator().manual_seed(4))
    logits = []
    cpu16 = _grads("cpu", "bfloat16", batch, proj, args.query_scale, logits)
    cpu32 = _grads("cpu", None, batch, proj, args.query_scale)
    print(f"{args.molecules} molecules, attention queries x {args.query_scale}")
    for n, (top, span, pmax) in enumerate(logits):
        print(f"  softmax {n}: max|logit| {top:.4g}, mean row range {span:.4g}, "
              f"mean largest probability {pmax:.4f}")
    gap = smoke._rel_l2(cpu16, cpu32)
    print(f"CPU bf16 vs f32, relative L2 over all parameters: {gap:.4e}")
    groups: dict[str, list[str]] = {}
    for name, g in cpu32.items():
        if g is not None:
            groups.setdefault(".".join(name.split(".")[:3]), []).append(name)
    for key, names in groups.items():
        part = smoke._rel_l2({n: cpu16[n] for n in names}, {n: cpu32[n] for n in names})
        print(f"  {key}: {part:.4f}")
    if args.card:
        card = _grads("cuda", "bfloat16", batch, proj, args.query_scale)
        fused = se3.pooled_conv
        se3.pooled_conv = pooled_conv_plain
        try:
            plain = _grads("cuda", "bfloat16", batch, proj, args.query_scale)
        finally:
            se3.pooled_conv = fused
        for what, got in (("kernels J and K", card), ("plain bf16 J and K", plain)):
            err = smoke._rel_l2(got, cpu16)
            print(f"card ({what}) vs CPU, both bf16: {err:.4e} = {err / gap:.4f} of the gap")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
