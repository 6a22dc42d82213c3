"""Where kernels A, J, K and L spend their time, on the card: each is rebuilt
with one part of its work switched off (A: with other tile shapes) and
timed beside the whole kernel,
the PyTorch call that computes its function (where there is one) and itself
again, at the batch-768 shapes of `chip_smoke.py` (its batch, kNN mask and
timer).

    python3 ablate_kernels.py

A (`csrc/segment_sum.cu`, the batch's hyperedge ids, D = 256): 32-row
  tiles (the kernel), 16 and 64 rows, 8 and 32 rows in flight a thread;
  `index_add_`; 10 calls a sample and device time alone (torch.profiler).
J (`csrc/pooled_conv_fwd.cu`, with the model's live sites, C = 1 and 3):
  full; consumers only (the producers neither copy nor build: the products
  and the barriers); producers only (the consumers skip the products: the
  copies, the M-builds and the barriers); `torch.einsum`.
K (`csrc/pooled_conv.cu`, with the model's live sites, C = 1 and 3): full;
  dM products only (the dM kernel skips the dh and dtc reductions); dM
  without products (its copies, stores and reductions); dW consumers only
  (its producers neither copy after the first chunk nor rebuild M); dW
  producers only (its consumers skip the products); the dM kernel with a
  W ring of 3 stages or stages of 32 o, its tile then as many sites as the
  shared memory left takes. Each variant's two
  kernels are also timed apart (torch.profiler, device time).
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

from chip_smoke import bench_batch, kernel_split, median_ms, pooled_mask, profiled_device_ms
from equihgnn_tpu_torch.ops.kernels import build

A_SRC, J_SRC, K_SRC, L_SRC = (build.CSRC_DIR / n for n in (
    "segment_sum.cu", "pooled_conv_fwd.cu", "pooled_conv.cu", "pooled_m.cu"))
_TR, _BATCH = "constexpr int TR = 32;", "constexpr int BATCH = 16;"
A_PATCHES = {  # name -> (patches, rows of a tile)
    "16-row tiles": ([(_TR, "constexpr int TR = 16;")], 16),
    "64-row tiles": ([(_TR, "constexpr int TR = 64;")], 64),
    "8 rows in flight": ([(_BATCH, "constexpr int BATCH = 8;")], 32),
    "32 rows in flight": ([(_BATCH, "constexpr int BATCH = 32;")], 32),
}
J_PATCHES = {  # name -> (text, its replacement)
    "consumers only": [("      build_a(d, n, b, p);", ""),
                       ("        load_wh<VEC>(h, w, d, n + 1, n_fc, o0, b, p);", ""),
                       ("        load_t<VEC>(tc, d, Chunk(n + 1, n_fc).ic, b, p);", "")],
    "producers only": [("    mma_chunk(d, n, b, acc);", "")],
}
_STAGES, _OC = "constexpr int STAGES = 2;", "constexpr int OC = 64;"
K_PATCHES = {
    "dM products only": [("    reduce_chunk(d, ts, ic, fc, b, fc + 1 == n_fc ? dtc : nullptr, dh_sums);",
                          "")],
    "dM no products": [("      mma_stage<MT>(d, q, b.w + (z % STAGES) * OC * WS, b, acc);", "")],
    "dW consumers only": [("      build_a(d, n, b, p);", ""),
                          ("        load_chunk<VEC>(h, tc, dout, d, n + 1, i0, f0, o0, b, p);", "")],
    "dW producers only": [("    mma_chunk(d, n, b, acc);", "")],
    # the dM kernel's W ring: depth (stages) and o of a stage; its tile then
    # takes as many sites as the shared memory left allows
    "dM 3 stages": [(_STAGES, "constexpr int STAGES = 3;")],
    "dM stages of 32 o": [(_OC, "constexpr int OC = 32;")],
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
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-shared",
                               "-o", str(libs[n]), str(s)],
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
        srcs = {"A full": A_SRC, "J full": J_SRC, "K full": K_SRC, "L full": L_SRC}
        for name, (patches, _) in A_PATCHES.items():
            srcs[f"A {name}"] = _patched(A_SRC, patches, tmp / f"a_{len(srcs)}.cu")
        for name, patches in J_PATCHES.items():
            srcs[f"J {name}"] = _patched(J_SRC, patches, tmp / f"j_{len(srcs)}.cu")
        for name, patches in K_PATCHES.items():
            srcs[f"K {name}"] = _patched(K_SRC, patches, tmp / f"k_{len(srcs)}.cu")
        for name, patches in L_PATCHES.items():
            srcs[f"L {name}"] = _patched(L_SRC, patches, tmp / f"l_{len(srcs)}.cu")
        libs = _build_all(tmp, srcs)
        batch = bench_batch()[1]
        ids = batch.hedge_idx.to(dev)
        m, n_seg = ids.shape[0], batch.num_hedges
        data = torch.randn(m, 256, device=dev)
        zeros = torch.zeros(n_seg, 256, device=dev)
        stream0 = torch.cuda.current_stream().cuda_stream
        an = [n for n in libs if n.startswith("A")]
        afns = []
        for name in an:
            rows = A_PATCHES[name[2:]][1] if name != "A full" else 32
            ws = 2 * -(-m // rows) * 256
            buf = torch.empty(n_seg * 256 + ws, device=dev)
            fn = libs[name].sorted_segment_sum_f32
            fn.argtypes = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 4 + (ctypes.c_void_p,)
            afns.append(lambda fn=fn, buf=buf, ws=ws: fn(
                data.data_ptr(), ids.data_ptr(), buf.data_ptr(),
                buf.data_ptr() + 4 * n_seg * 256, ws, m, 256, n_seg, stream0))
        afns += [lambda: zeros.index_add_(0, ids, data), afns[0]]
        times = median_ms(*afns, reps=10)
        dev_ms = [profiled_device_ms(fn) for fn in afns[:-1]]
        print("A (10 calls a sample; device alone): " + ", ".join(
            f"{n} {t:.4f} / {dv:.4f} ms" for n, t, dv in
            zip(an + ["index_add_"], times, dev_ms)) + f", A full again {times[-1]:.4f} ms")
        mask = pooled_mask(batch)
        g, a, k = mask.shape
        s, f, i, o = g * a, 128, 256, 256
        sites = live_sites(mask.any(-1))
        gen = torch.Generator().manual_seed(1)
        stream = torch.cuda.current_stream().cuda_stream
        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        jn = [n for n in libs if n.startswith("J")]
        kn = [n for n in libs if n.startswith("K")]
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
        for c in (1, 3):
            h = torch.randn(g, a, k, f, generator=gen).to(dev) * mask[..., None]
            tc = torch.randn(g, a, k, c * i, generator=gen).to(dev) * mask[..., None]
            w = (torch.rand(f, o, i, generator=gen) * 2 - 1).to(dev) / f ** 0.5
            dout = torch.randn(g, a, c, o, generator=gen).to(dev)
            dh, dtc, dw = torch.empty_like(h), torch.empty_like(tc), torch.empty_like(w)
            fns, floats = [], ctypes.c_int64()
            for name in kn:
                lib = libs[name]
                lib.pooled_conv_bwd_workspace_f32.argtypes = (I, I, I, ctypes.POINTER(I64))
                lib.pooled_conv_bwd_workspace_f32(i, f, o, ctypes.byref(floats))
                ws = torch.empty(floats.value, device=dev)  # each variant's own W layout
                fn = lib.pooled_conv_bwd_f32
                fn.argtypes = (P,) * 10 + (I,) * 6 + (P,)
                fns.append(lambda fn=fn, ws=ws: fn(h.data_ptr(), tc.data_ptr(), w.data_ptr(),
                                                   dout.data_ptr(), sites.ids.data_ptr(),
                                                   sites.count.data_ptr(), dh.data_ptr(),
                                                   dtc.data_ptr(), dw.data_ptr(), ws.data_ptr(),
                                                   s, k, c, i, f, o, stream))
            times = median_ms(*fns, fns[0], iters=5)
            print(f"K C={c}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                           zip(kn + ["K full again"], times)))
            for name, fn in zip(kn, fns):
                print(f"  K C={c} {name} by kernel: " + ", ".join(
                    f"{kname} {t:.4f} ms" for kname, t in kernel_split(fn).items()))
            del h, tc, w, dout, dh, dtc, dw, ws, fns
            torch.cuda.empty_cache()
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
