"""How often the float32 attention kernel restarts its S sums from zero:
time against accuracy, on the card.

``mma.sync`` truncates the sums it accumulates toward zero, so
``flash_attention_kernel`` (src/repro_torch/kernels/csrc/flash_attention.cu)
sums S ``kSSteps`` k-steps at a time from zero, and each tile's P V whole,
before adding them in float32.  This script builds the kernel's library
with ``kSSteps`` = 16 (S one chain from zero at hd 128), 8, 4 (the
kernel's) and 2, and at olmo-1b's scoring shape (4 x 16 heads, 2048
tokens, hd 128, float32) prints each one's time (CUDA events), its
largest distance from a float64 attention and from the plain version, and
ptxas' registers and spills.  It needs a CUDA card and nvcc:

    python3 tools/flash_f32_sums.py

The variants are built under build/kernels/s_steps/ (gitignored).
"""

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

STEPS = (16, 8, 4, 2)
SHAPE = (64, 2048, 128)
DEFINE = re.compile(r"constexpr int kSSteps = \d+;")


def build(steps: int):
    """The library with ``kSSteps = steps``: (path, ptxas summary)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    if not DEFINE.search(src):
        raise RuntimeError("kSSteps not found in flash_attention.cu")
    out_dir = _build.BUILD_DIR / "s_steps" / str(steps)
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "flash_attention.cu"
    cu.write_text(DEFINE.sub(f"constexpr int kSSteps = {steps};", src))
    lib = out_dir / "flash_attention.so"
    cmd = [_build.tool("nvcc"), *_build.NVCC_FLAGS, "-o", str(lib), str(cu),
           *_build.EXTRA_FLAGS["flash_attention"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):   # <128, 128, float>
        if "flash_attention_kernelILi128ELi128EfE" in line \
                and "Compiling entry" in line:
            return lib, " ".join(x.split(":", 1)[-1].strip()
                                 for x in lines[i + 1:i + 4])
    raise RuntimeError("no ptxas entry for flash_attention_kernel<128,128>")


def launch(lib, q, k, v, causal):
    out = torch.empty_like(v)
    err = lib.flash_attention_launch(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), q.shape[0], q.shape[1], k.shape[1], q.shape[2],
        v.shape[2], float(q.shape[2] ** -0.5), int(causal), 0,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def attention_f64(q, k, v, causal):
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    above = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                       device=q.device).triu(1)
    for h in range(0, q.shape[0], 8):
        s = torch.einsum("bqd,bkd->bqk", q[h:h + 8].double(),
                         k[h:h + 8].double()) * q.shape[2] ** -0.5
        if causal:
            s = s.masked_fill(above, fa.NEG_INF)
        out[h:h + 8] = torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1),
                                    v[h:h + 8].double())
    return out


def ms(fn, reps=10):
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(len(STEPS)) as pool:
        built = dict(zip(STEPS, pool.map(build, STEPS)))
    libs = {}
    for steps, (path, ptxas) in built.items():
        lib = ctypes.CDLL(str(path))
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        libs[steps] = lib
        print(f"kSSteps {steps:2d}: {ptxas}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=gen, device="cuda")
               for _ in range(3))
    for causal in (True, False):
        want = attention_f64(q, k, v, causal)
        plain = fa.flash_attention_plain(q, k, v, causal=causal)
        print(f"{'causal' if causal else 'full'} {SHAPE}: plain "
              f"|x - f64| {float((plain - want).abs().max()):.4e}",
              flush=True)
        for steps, lib in libs.items():
            got = launch(lib, q, k, v, causal)
            t = ms(lambda: launch(lib, q, k, v, causal))
            print(f"  kSSteps {steps:2d}: {t:.4f} ms, |x - f64| "
                  f"{float((got - want).abs().max()):.4e}, |x - plain| "
                  f"{float((got - plain).abs().max()):.4e}", flush=True)
        del want, plain
    return 0


if __name__ == "__main__":
    sys.exit(main())
