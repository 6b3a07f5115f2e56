#!/usr/bin/env python3
"""Time the two exact tensor-core formulations of the agreement search.

    python3 tools/search_mma_probe.py      # from the root, on an H100

Builds ``tools/search_mma_probe.cu`` with the kernels' own nvcc command
(``repro_torch.kernels._build``) into their build directory and prints,
for ``mma.sync`` m16n8k256 b1 (``.and.popc`` and ``.xor.popc``; the
library holds both, so building it shows ptxas takes ``.xor.popc`` for
sm_90a) and m16n8k32 s8 (with and without the 0/1 byte unpack of the B
fragment), and for ``wgmma`` m64n128k32 s8 and m64n128k16 bf16 from
shared memory and m64n80k32 s8 with A from registers (``am_matmul``'s
instructions), the issue rate per SM and clock (the SM clock
``nvidia-smi`` reports as ``clocks.max.sm``, as chip_smoke takes it),
the operations a second against the dense peaks the bounds use (1,979
TOP/s int8, 989 TFLOP/s bf16), and the time the main path's search
(B = 256 reads, S = 9,780 prototypes, D = 40,960 bits) would need at
that rate.  It also checks the b1 fragment mapping the fused kernel
relies on, on one warp.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, S, D = 256, 9780, 40960


def nvidia_smi(query: str, nounits: bool = False) -> str:
    fmt = "csv,noheader,nounits" if nounits else "csv,noheader"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("search_mma_probe: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    lib_path = _build.build_dir() / "search_mma_probe.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(_build.nvcc_command(ROOT / "tools" / "search_mma_probe.cu",
                                       lib_path), check=True)
    print("[probe] .xor.popc for sm_90a: accepted (built with .and.popc)")

    lib = ctypes.CDLL(str(lib_path))
    lib.probe_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.layout_check_launch.argtypes = [ctypes.c_void_p] * 4
    stream = _build.current_stream()

    rng = np.random.default_rng(1)
    a = rng.integers(0, 2 ** 32, (16, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (8, 8), dtype=np.uint32)
    want = np.array([[sum(bin(int(x & y)).count("1") for x, y in zip(ra, rb))
                      for rb in b] for ra in a])
    ta = torch.from_numpy(a.view(np.int32)).cuda()
    tb = torch.from_numpy(b.view(np.int32)).cuda()
    tc = torch.zeros((16, 8), dtype=torch.int32, device="cuda")
    assert lib.layout_check_launch(*map(_build.ptr, (ta, tb, tc)),
                                   stream) == 0
    got = tc.cpu().numpy()
    print(f"[probe] b1 fragment mapping (words 2 tig, 2 tig + 1 of rows g, "
          f"g + 8): {'exact' if (got == want).all() else 'WRONG'}")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = float(nvidia_smi("clocks.max.sm", nounits=True)) * 1e6
    out = torch.empty(sms * 4 * 512, dtype=torch.int32, device="cuda")
    # kind: (name, multiply-adds an instruction, blocks, threads,
    #        instructions a launch / iters, the dense peak in OP/s)
    kinds = {0: ("b1 m16n8k256 .and.popc", 16 * 8 * 256, sms * 4, 512,
                 sms * 4 * 16 * 8, None),
             1: ("s8 m16n8k32", 16 * 8 * 32, sms * 4, 512, sms * 4 * 16 * 8,
                 1979e12),
             2: ("s8 m16n8k32 + B unpack", 16 * 8 * 32, sms * 4, 512,
                 sms * 4 * 16 * 8, 1979e12),
             3: ("b1 m16n8k256 .xor.popc", 16 * 8 * 256, sms * 4, 512,
                 sms * 4 * 16 * 8, None),
             4: ("wgmma s8 m64n128k32, A and B in smem", 64 * 128 * 32,
                 sms * 2, 256, sms * 2 * 2 * 4, 1979e12),
             5: ("wgmma bf16 m64n128k16, A and B in smem", 64 * 128 * 16,
                 sms * 2, 256, sms * 2 * 2 * 4, 989e12),
             6: ("wgmma s8 m64n80k32, A in registers", 64 * 80 * 32,
                 sms * 2, 256, sms * 2 * 2 * 4, 1979e12)}
    iters = 4096
    for kind, (name, macs, blocks, threads, per_iter, peak) in kinds.items():
        def run():
            assert lib.probe_launch(kind, blocks, threads, iters,
                                    _build.ptr(out), stream) == 0
        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        torch.cuda.synchronize()
        sec = start.elapsed_time(end) / 5 / 1e3
        rate = per_iter * iters / sec
        need = B * S * D / macs
        share = ("" if peak is None else
                 f" ({2 * macs * rate / peak * 100:.1f} % of the "
                 f"{peak / 1e12:.0f} T dense peak)")
        print(f"[probe] {name}: {rate / 1e12:.4f} T instr/s "
              f"({rate / sms / clock:.3f} per SM per clock at "
              f"{clock / 1e6:.0f} MHz), {2 * macs * rate / 1e12:.1f} "
              f"TOP/s{share}; the main-path search ({need:.3e} "
              f"instructions) would take {need / rate * 1e3:.4f} ms")
    print(f"[probe] card: {nvidia_smi('name,power.limit')} | clocks.sm now "
          f"{nvidia_smi('clocks.sm')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
