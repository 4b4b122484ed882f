"""Phase trace of the ``fused_stream`` kernel at the serving commit, on
the card.

Builds ``src/repro_torch/csrc/fused_stream.cu`` with nvcc as it is
(``fused``: a row the plan holds in one tile runs the resident-row
kernel) and with that choice taken out (``fused_tiled``: every plan
runs the tiled kernel), each also with ``clock64()`` read by block 0's
first thread at each phase of either kernel (entry, the tile's start,
the staged window or row, each move, the stores, the end).  Each
``--baseline FILE`` adds an earlier version built the same two ways, its
descriptor's layout read from the file: the kernel as it was before it
was tiled (``git show 1c82fc2:src/repro_torch/csrc/fused_stream.cu >
FILE``), or an earlier tiled one.  Then, on the commit's (4, 320) int32
rows and its insert -> truncate, and on the cost model's probe stream
over (64, 16,384) and (64, 1,048,576) rows (``chip_smoke._fused_cases``),
each build is held bit for bit against ``fused_stream_plain`` and timed
with ``torch.profiler`` in three interleaved windows, and the stamped
builds' phases at the commit are printed in cycles, with the SASS
instructions (``cuobjdump -sass``) between the tiled kernel's first two
stamps.  Builds under the checkout's ``build/trace_fused_stream``.

    python3 tools/trace_fused_stream.py [--baseline FILE]
"""
import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
from repro_torch.kernels import cpm_kernels as ck  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
BUILD = ROOT / "build" / "trace_fused_stream"

STAMPS = r'''
__device__ long long g_stamp[16];
#define STAMP(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) \
    g_stamp[k] = clock64(); } while (0)
extern "C" int read_stamps(long long* s) {
  return (int)cudaMemcpyFromSymbol(s, g_stamp, sizeof g_stamp);
}
'''

#: (anchor, its replacement) in the tiled kernel: stamp k at phase k
INCLUDE = ('#include "cpm_ops.cuh"', '#include "cpm_ops.cuh"\n' + STAMPS)
TILED = (
    INCLUDE,
    ("  extern __shared__ __align__(16) uint32_t smem[];\n",
     "  STAMP(0);\n  extern __shared__ __align__(16) uint32_t smem[];\n"),
    ("  const long long rowoff = (long long)row * n;\n  const uint32_t* rin",
     "  STAMP(1);\n  const long long rowoff = (long long)row * n;\n"
     "  const uint32_t* rin"),
    (("  __syncthreads();\n  if (!lead_move)",
      "  __syncthreads();\n  STAMP(2);\n  if (!lead_move)"),
     ("  __syncthreads();\n  if (lead && s == first) {",
      "  __syncthreads();\n  STAMP(2);\n  if (lead && s == first) {")),
    ("        __syncthreads();                          // nxt complete\n",
     "        __syncthreads();\n        STAMP(3);\n"),
    ("  uint32_t* rout = out + rowoff;\n",
     "  STAMP(4);\n  uint32_t* rout = out + rowoff;\n"),
    ("  __syncthreads();                                // buffers reused\n",
     "  __syncthreads();\n  STAMP(5);\n"),
    ("    first = end;\n  }\n}\n", "    first = end;\n  }\n  STAMP(6);\n}\n"),
)
TILED_PHASES = ("entry -> tile", "tile -> window staged", "window -> moved",
                "moved -> stores", "stores", "tile -> exit")

#: the same in the untiled kernel of commit 1c82fc2 (fused_stream_kernel)
FIRST = (
    INCLUDE,
    ("  extern __shared__ uint32_t rowbuf[];",
     "  STAMP(0);\n  extern __shared__ uint32_t rowbuf[];"),
    ("    int ul = ul_in[row];                               // length "
     "register\n    __syncthreads();\n",
     "    int ul = ul_in[row];\n    __syncthreads();\n    STAMP(2);\n"),
    ("        __syncthreads();                               // nxt complete"
     "\n", "        __syncthreads();\n        STAMP(3);\n"),
    ("    uint32_t* out_row = xo + (long long)row * n;\n",
     "    STAMP(4);\n    uint32_t* out_row = xo + (long long)row * n;\n"),
    ("    __syncthreads();                                   // buffers "
     "reused\n  }\n}\n", "    __syncthreads();\n  }\n  STAMP(6);\n}\n"),
)
FIRST_PHASES = ("entry -> row staged", "row -> moved", "moved -> stores",
                "stores -> exit")
#: the resident-row kernel's marks in the tiled source (no include)
RESIDENT = FIRST[1:]
#: fused_stream_launch with its choice of the resident-row kernel taken out
TILED_ONLY = (("  if ((long long)n <= prog->tile && 8LL * n <= 232448) {",
               "  if (false) {"),)


def instrument(text: str, marks) -> str:
    """``text`` with the stamps put at ``marks``: an (anchor, replacement)
    pair, or a tuple of such pairs of which the first whose anchor occurs
    is used; an anchor must occur exactly once."""
    for mark in marks:
        pairs = mark if isinstance(mark[0], tuple) else (mark,)
        for anchor, replacement in pairs:
            if anchor in text:
                break
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once: {anchor!r}")
        text = text.replace(anchor, replacement)
    return text


def program_type(text: str):
    """The ctypes layout of the ``FsProgram`` that ``text`` declares."""
    body = re.search(r"struct FsProgram \{(.*?)\};", text, re.S).group(1)
    sizes = {"FS_MAX_INSTR": ck.MAX_INSTR, "FS_MAX_TAPS": ck.MAX_TAPS}
    types = {"int": ctypes.c_int, "float": ctypes.c_float,
             "FsInstr": ck._Instr}
    fields = []
    for line in body.splitlines():
        m = re.match(r"\s*(int|float|FsInstr) ([^;]+);", line)
        for name in (m.group(2).split(",") if m else ()):
            a = re.match(r"\s*(\w+)\[(\w+)\]", name)
            fields.append((a.group(1), types[m.group(1)] * sizes[a.group(2)])
                          if a else (name.strip(), types[m.group(1)]))
    return type("FsProgram", (ctypes.Structure,), {"_fields_": fields})


def descriptor(text: str, prog):
    """The package's descriptor ``prog`` in the layout ``text`` declares
    (a ``pass_lead`` array for ``lead_mask``; no plan for the first
    design)."""
    kind = program_type(text)
    out = kind()
    for f, _ in kind._fields_:
        if f in ("ins", "taps", "pass_end"):
            ctypes.memmove(ctypes.addressof(getattr(out, f)),
                           ctypes.addressof(getattr(prog, f)),
                           ctypes.sizeof(getattr(out, f)))
        elif f == "pass_lead":
            for j in range(ck.MAX_INSTR):
                out.pass_lead[j] = prog.lead_mask >> j & 1
        else:
            setattr(out, f, getattr(prog, f))
    return kind, out


def build(name: str, text: str):
    """nvcc ``text`` into ``BUILD/<name>.so`` with the package's flags."""
    from repro_torch.kernels import _build

    BUILD.mkdir(parents=True, exist_ok=True)
    src = BUILD / f"{name}.cu"
    src.write_text(text)
    lib = BUILD / f"{name}.so"
    cmd = [_build.nvcc_path(), *_build._flags("fused_stream"), f"-I{CSRC}",
           "-o", str(lib), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{out.stderr}")
    regs = re.findall(r"Compiling entry function '\S*?(\w+_kernel)\w*'.*?"
                      r"(\d+) bytes spill stores.*?Used (\d+) registers",
                      out.stdout + out.stderr, re.S)
    return name, lib, regs


def prologue_sass(lib: Path) -> dict:
    """The SASS instructions of ``lib``'s stamped ``fused_tiles_kernel``
    between its first two clock reads (entry -> the tile's start), by
    opcode."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    body = re.search(r"Function : \S*fused_tiles_kernel\S*\n(.*?)"
                     r"(?=\n\s*Function :|\Z)", sass, re.S).group(1)
    ins = [m.group(1) for m in re.finditer(
        r"/\*[0-9a-f]{4,6}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)[^\n]*",
        body)]
    clocks = [i for i, m in enumerate(re.finditer(
        r"/\*[0-9a-f]{4,6}\*/[^\n]*", body)) if "SR_CLOCKLO" in m.group(0)]
    ops = {}
    for op in ins[clocks[0] + 1:clocks[1]]:
        op = op.split(".")[0]
        ops[op] = ops.get(op, 0) + 1
    return dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="an earlier fused_stream.cu (repeatable)")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    fused = (CSRC / "fused_stream.cu").read_text()
    sources = {"fused": fused, "fused_tiled": instrument(fused, TILED_ONLY)}
    sources.update((p.stem, p.read_text()) for p in args.baseline)
    texts = {}
    for name, text in sources.items():
        texts[name] = text
        if "fused_tiles_kernel" not in text:
            marks = FIRST
        elif "fused_resident_kernel" in text:
            marks = TILED + RESIDENT
        else:
            marks = TILED
        texts[f"{name}_stamps"] = instrument(text, marks)
    with ThreadPoolExecutor(len(texts)) as pool:
        built = list(pool.map(lambda kv: build(*kv), texts.items()))
    libs = {}
    for name, path, regs in built:
        print(f"{name}: (kernel, spill store bytes, registers) {regs}")
        libs[name] = ctypes.CDLL(str(path))
        if name.endswith("_stamps") and "fused_tiles_kernel" in texts[name]:
            ops = prologue_sass(path)
            print(f"{name}: {sum(ops.values())} SASS instructions from "
                  f"entry to the tile's start: {ops}")

    cases = cs._fused_cases(torch, dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(name, args):
        """A call of build ``name``'s kernel on the lowered ``args`` and the
        outputs it writes (rows, lengths, producer outputs)."""
        x, ul, descs, opnds = args
        r, n = x.shape
        used, prods = ck._fused_args(x, ul, descs)
        plan = ck.fused_plan(r, n, tuple((op, st) for op, st, _ in descs))
        if len(plan.passes) != 1:
            raise SystemExit("the traced cases are plans of one pass")
        _, desc = descriptor(texts[name],
                             ck._describe(descs, opnds, x, prods, plan))
        ox, ou = torch.empty_like(x), torch.empty_like(used)
        f = libs[name].fused_stream_launch
        if "void* scratch" in texts[name]:         # a tiled version
            f.argtypes = [P, P, P, P, P, P, I, I, I, P, P]
            a = (x.data_ptr(), ox.data_ptr(), None, used.data_ptr(),
                 ou.data_ptr(), None, r, n, 1, ctypes.addressof(desc),
                 stream)
        else:
            f.argtypes = [P, P, P, P, I, I, I, P, P]
            a = (x.data_ptr(), ox.data_ptr(), used.data_ptr(), ou.data_ptr(),
                 r, n, 1, ctypes.addressof(desc), stream)

        def call(desc=desc):
            if f(*a):
                raise SystemExit(f"{name}: launch failed")

        return call, (ox, ou, *prods), plan

    calls = {}
    for tag in ("commit", "probe16k", "probe1m"):
        args = cs._lowered(torch, *cases[tag])
        n = args[0].shape[1]
        x, ul, descs, opnds = args
        plain = ck.fused_stream_plain(x.cpu(), ul.cpu(), descs,
                                      tuple(o.cpu() for o in opnds))
        want = (plain[0], plain[1], *plain[2])
        names = [k for k in libs if tag == "commit" or (
            not k.endswith("_stamps") and ("fused_tiles_kernel" in texts[k]
                                           or 8 * n <= ck.MAX_SMEM_BYTES))]
        timed = {}
        for name in names:
            call, outs, plan = launcher(name, args)
            call()
            torch.cuda.synchronize()
            same = all(torch.equal(g.cpu(), w) for g, w in zip(outs, want))
            print(f"{tag} {tuple(args[0].shape)} {name}: plan {plan}; bit "
                  f"for bit with fused_stream_plain: {same}")
            if not same:
                return 1
            timed[name] = call
        calls[tag] = timed
        iters = 300 if tag == "commit" else 20
        times = {name: [] for name in timed}
        for seq in (list(timed), list(timed)[::-1], list(timed)):
            for name in seq:
                by = cs.kernel_ms(timed[name], iters)
                times[name].append(sum(by.values()) if by else None)
        for name, ts in times.items():
            print(f"{tag} {name}: device ms a launch in three windows "
                  + ", ".join("no record" if v is None else f"{v:.5f}"
                              for v in ts) + f"; {card.strip()}")

    for name in (k for k in libs if k.endswith("_stamps")):
        read = libs[name].read_stamps
        read.argtypes = [P]
        for _ in range(3):
            for _ in range(20):
                calls["commit"][name]()
            torch.cuda.synchronize()
            s = (ctypes.c_longlong * 16)()
            if read(ctypes.cast(s, P)) != 0:
                raise SystemExit("read_stamps failed")
            idx = [k for k in range(16) if s[k]]
            d = [s[b] - s[a] for a, b in zip(idx, idx[1:])]
            phases = TILED_PHASES if s[1] else FIRST_PHASES   # which ran
            print(f"{name}: cycles " + ", ".join(
                f"{p} {c}" for p, c in zip(phases, d))
                  + f"; entry to exit {s[idx[-1]] - s[idx[0]]}")

    return 0


if __name__ == "__main__":
    sys.exit(main())
