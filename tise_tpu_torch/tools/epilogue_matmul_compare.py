"""Time kernel K3 (``csrc/epilogue_matmul.cu``) beside ``torch.addmm`` on the card.

``--also FILE.cu`` adds another source with the same C entry (an earlier
design, say): it is compiled next to the committed one, held against the
plain version and against the committed kernel bit for bit, and timed in
turns with it inside one process, so that the numbers compare on one card
under one power limit.  ``--sass`` counts the SASS lines of the committed
kernel's interior main loop by opcode (``cuobjdump -sass``): the share that
are multiply-adds is the ceiling the dispatch slots set.

Usage: python -m tise_tpu_torch.tools.epilogue_matmul_compare [--n 2048 ...] [--sass] [--also FILE.cu ...]
(needs one CUDA card and nvcc)
"""

from __future__ import annotations

import collections
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict

import torch

from tise_tpu_torch.core.config import configure_precision, resolve_device
from tise_tpu_torch.ops import native, pallas_kernels
from tise_tpu_torch.ops.pallas_kernels import epilogue_matmul_kernel, epilogue_matmul_plain


class _Counter:
    launches = 0


def build_also(src: Path) -> native.CFunction:
    """Compile another source with K3's C entry; its bound entry."""
    out_dir = native.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{src.stem}.so"
    done = subprocess.run([native.nvcc(), *native.NVCC_FLAGS, "-o", str(lib), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{done.stdout}")
    native._LIBS[str(lib)] = ctypes.CDLL(str(lib))  # native.library() then finds it under its path
    return native.CFunction(str(lib), "tise_epilogue_matmul", pallas_kernels._EPILOGUE_MATMUL.argtypes)


def main_loop_opcodes(lib: Path) -> Dict[str, int]:
    """Opcode counts of the interior instance's main loop: from a dozen
    lines ahead of its barrier to its last multiply-add."""
    cuobjdump = Path(native.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True, text=True).stdout
    interior = sass[sass.index("epilogue_matmul_kernelILi0EEE"):]
    ops = [m.group(1) for m in re.finditer(r"\n\s+/\*[0-9a-f]{4}\*/\s+(.*?);", interior)]
    barrier = next(i for i, op in enumerate(ops) if "BAR.SYNC" in op)
    last = max(i for i, op in enumerate(ops) if "FFMA" in op)
    names = (re.sub(r"^@!?U?P\w+\s+", "", op).split(".")[0].split()[0] for op in ops[barrier - 12:last + 2])
    return dict(collections.Counter(names).most_common())


def run_also(fn: native.CFunction, a: torch.Tensor, b: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    n = a.shape[0]
    out = torch.empty((n, n), dtype=torch.float32, device=a.device)
    native.launch(fn, _Counter, a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, n, n, alpha, beta)
    return out


def event_ms(fn, inner: int = 10) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, nargs="+", default=[2048])
    p.add_argument("--also", action="append", default=[], help="another .cu with the same C entry")
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--sass", action="store_true", help="count the main loop's SASS lines by opcode")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("epilogue_matmul_compare times CUDA kernels; it has nothing to measure on the CPU")
    configure_precision("highest")
    native.library("epilogue_matmul")
    for line in native.BUILD_LOG.get("epilogue_matmul", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] epilogue_matmul: {line.strip()}")
    also = {f"also_{Path(f).stem}": build_also(Path(f)) for f in args.also}
    if args.sass:
        counts = main_loop_opcodes(native._target(native.CSRC / "epilogue_matmul.cu"))
        total = sum(counts.values())
        print(f"[sass] epilogue_matmul: main loop {total} SASS lines, {counts.get('FFMA', 0)} FFMA "
              f"({counts.get('FFMA', 0) / total:.3f}); {counts}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} / {smi}")

    alpha, beta = 1.5, -0.5
    for n in args.n:
        gen = torch.Generator(device=device).manual_seed(0)
        a = torch.randn(n, n, generator=gen, device=device)
        b = torch.randn(n, n, generator=gen, device=device)
        ref = epilogue_matmul_plain(a, b, alpha, beta)
        scale = float(ref.abs().max())
        timed = {"epilogue_matmul": lambda: epilogue_matmul_kernel(a, b, alpha, beta)}
        timed.update({tag: (lambda fn=fn: run_also(fn, a, b, alpha, beta)) for tag, fn in also.items()})
        first = None
        for tag, fn in timed.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.allclose(got, ref, rtol=1e-4, atol=1e-4 * scale):
                raise RuntimeError(f"{tag} disagrees with the plain version by {float((got - ref).abs().max())}")
            first = got if first is None else first
            print(f"[check] n={n} {tag}: max_abs_err {float((got - ref).abs().max()):.3e} vs plain; "
                  f"bit-equal to epilogue_matmul: {torch.equal(got, first)}")
        eye = alpha * torch.eye(n, device=device)
        timed["torch.addmm"] = lambda: torch.addmm(eye, a, b, beta=1.0, alpha=beta)
        for fn in timed.values():
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        times = {tag: [] for tag in timed}
        for r in range(args.rounds):  # in turns, forwards then backwards
            for tag in (list(timed) if r % 2 == 0 else reversed(list(timed))):
                times[tag].append(event_ms(timed[tag]))
        for tag, ts in times.items():
            med = statistics.median(ts)
            print(f"[time] n={n} {tag:28s} median {med:.4f} ms (min {min(ts):.4f}, max {max(ts):.4f}); "
                  f"{2 * n ** 3 / med / 1e9:.2f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
