"""Where kernels J and L spend their time, on the card: each is rebuilt with
one part of its work switched off and timed beside the whole kernel, the
PyTorch call that computes its function and itself again, at the batch-768
shapes of `chip_smoke.py` (its batch, kNN mask and timer).

    python3 ablate_kernels.py

J (`csrc/pooled_conv_fwd.cu`, with the model's live sites, C = 1 and 3):
  full; consumers only (the producers neither copy nor build: the products
  and the barriers); producers only (the consumers skip the products: the
  copies, the M-builds and the barriers); `torch.einsum`.
L (`csrc/pooled_m.cu`, bf16, X = 64 and 192): full; without the zero-site
  skip; without the products (the ring and the stores); `torch.bmm`.
A variant is the source with exact lines removed or replaced; a line that is
not in the source once stops the script. A variant's output is wrong by
design and is not checked. Times: `chip_smoke.median_ms`, 10 samples (L: of
10 calls back to back), the variants alternating. Needs nvcc and one card;
writes nothing outside a temporary directory.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from chip_smoke import bench_batch, median_ms, pooled_mask
from equihgnn_tpu_torch.ops.kernels import build

J_SRC, L_SRC = build.CSRC_DIR / "pooled_conv_fwd.cu", build.CSRC_DIR / "pooled_m.cu"
J_PATCHES = {  # name -> (text, its replacement)
    "consumers only": [("      build_a(d, n, b, p);", ""),
                       ("        load_wh<VEC>(h, w, d, n + 1, n_fc, o0, b, p);", ""),
                       ("        load_t<VEC>(tc, d, Chunk(n + 1, n_fc).ic, b, p);", "")],
    "producers only": [("    mma_chunk(d, n, b, acc);", "")],
}
L_PATCHES = {
    "no zero-site skip": [("for (int k = 0; nonzero && k < d.k; ++k)", "for (int k = 0; k < d.k; ++k)")],
    "no products": [("for (int k = 0; nonzero && k < d.k; ++k)", "for (int k = 0; false; ++k)")],
}


def _patched(src: Path, patches, out: Path) -> Path:
    text = src.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"{src.name}: {old!r} is not in the source once")
        text = text.replace(old, new)
    out.write_text(text)
    return out


def _build_all(tmp: Path, srcs: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    nvcc = build._nvcc()
    libs = {name: tmp / f"lib{i}.so" for i, name in enumerate(srcs)}
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(libs[n]), str(s)],
                              stderr=subprocess.PIPE, text=True) for n, s in srcs.items()]
    for proc, name in zip(procs, srcs):
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
    return {name: ctypes.CDLL(str(path)) for name, path in libs.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from equihgnn_tpu_torch.ops.kernels.pooled_conv import live_sites

    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        srcs = {"J full": J_SRC, "L full": L_SRC}
        for name, patches in J_PATCHES.items():
            srcs[f"J {name}"] = _patched(J_SRC, patches, tmp / f"j_{len(srcs)}.cu")
        for name, patches in L_PATCHES.items():
            srcs[f"L {name}"] = _patched(L_SRC, patches, tmp / f"l_{len(srcs)}.cu")
        libs = _build_all(tmp, srcs)
        mask = pooled_mask(bench_batch()[1])
        g, a, k = mask.shape
        s, f, i, o = g * a, 128, 256, 256
        sites = live_sites(mask.any(-1))
        gen = torch.Generator().manual_seed(1)
        stream = torch.cuda.current_stream().cuda_stream
        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        jn = [n for n in libs if n.startswith("J")]
        ln = [n for n in libs if n.startswith("L")]
        for c in (1, 3):
            h = torch.randn(g, a, k, f, generator=gen).to(dev) * mask[..., None]
            tc = torch.randn(g, a, k, c * i, generator=gen).to(dev) * mask[..., None]
            w = (torch.rand(f, o, i, generator=gen) * 2 - 1).to(dev) / f ** 0.5
            out = torch.zeros(g, a, c, o, device=dev)
            fns = []
            for name in jn:
                fn = libs[name].pooled_conv_fwd_f32
                fn.argtypes = (P, P, P, P, P, P, I, I, I, I, I, I, P)
                fns.append(lambda fn=fn: fn(h.data_ptr(), tc.data_ptr(), w.data_ptr(),
                                            sites.ids.data_ptr(), sites.count.data_ptr(),
                                            out.data_ptr(), s, k, c, i, f, o, stream))
            fns += [lambda: torch.einsum("gakf,gakci,foi->gaco", h, tc.view(g, a, k, c, i), w),
                    fns[0]]
            times = median_ms(*fns, iters=10)
            print(f"J C={c}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                           zip(jn + ["torch.einsum", "J full again"], times)))
        for x in (64, 192):
            h = (torch.randn(g, a, k, f, generator=gen).to(dev) * mask[..., None]).bfloat16()
            tc = (torch.randn(g, a, k, x, generator=gen).to(dev) * mask[..., None]).bfloat16()
            m = torch.empty(g, a, x, f, device=dev, dtype=torch.bfloat16)
            fns = []
            for name in ln:
                fn = libs[name].pooled_m_fwd_bf16
                fn.argtypes = (P, P, P, I64, I, I, I, P)
                fns.append(lambda fn=fn: fn(h.data_ptr(), tc.data_ptr(), m.data_ptr(), s, k, f, x,
                                            stream))
            fns += [lambda: torch.bmm(tc.view(s, k, x).transpose(1, 2), h.view(s, k, f)), fns[0]]
            times = median_ms(*fns, iters=10, reps=10)
            print(f"L X={x}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                           zip(ln + ["torch.bmm", "L full again"], times)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
