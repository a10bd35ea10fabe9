"""Hold this tree's builds of ``csrc/convnext_block.cu`` and
``csrc/row_mlp.cu`` against another tree's builds of whichever of the two it
has (the row forms #5 and #7 lived in ``convnext_block.cu`` before #1's
``wgmma`` form): the SASS of every kernel the two builds share, each kernel's
registers and stack, the kernels only one of them has, and the time of #5
(``svt_mlp_forward``) at the shapes of its path, #7 (``svt_ln_mlp_forward``)
and #1 in its training form (``svt_convnext_block_forward`` with t) at the
train step's, launched from each build in turn. Each entry point is called
through its own build's C interface: the mma.sync forms take no scratch, the
wgmma forms take their y and h (``_scratch``).

    python -m spine_vision_torch.probes.build_diff --parent DIR
    python -m spine_vision_torch.probes.build_diff --parent DIR --case ln_mlp_bwd
    python -m spine_vision_torch.probes.build_diff --parent DIR --case dwconv_bwd
    python -m spine_vision_torch.probes.build_diff --parent DIR --case dw_fwd

The ``ln_mlp_bwd`` case builds both trees' ``csrc/ln_mlp_bwd.cu`` and
``csrc/block_train_bwd.cu`` (which includes its header) instead: each build's
kernels with their registers, stack and spills, the SASS of every kernel the
builds share, then #8/#9 (``svt_ln_mlp_bwd``), #6 (``svt_mlp_bwd``) and #10
(``svt_block_train_bwd``) at the train step's shapes, both builds called
through this tree's C interface (the Hopper form's) with their
own scratch, device time a call in the order parent, tree, tree, parent, and
the two builds' outputs held within 2e-2 of max |parent| of each other.

The ``dwconv_bwd`` case builds both trees' ``csrc/dwconv_bwd.cu`` (#4 and
#3) and the sources that share its headers, ``dwconv_ln.cu``,
``convnext_block.cu`` and ``block_train_bwd.cu``, whose SASS must match the
parent's kernel for kernel (it raises otherwise); then #4 (``svt_dw_ln_bwd``)
and #3 (``svt_dwconv7x7``, on x with the flipped filter) at the all-kernel
step's four shapes, each build through its own C interface with its own
workspace, device time a call in the order parent, tree, tree, parent, the
outputs within the card tests' tolerances of max |parent| (2e-2 for #4,
1e-2 for #3), and each build's call split into its kernels (a profile).

The ``dw_fwd`` case is for a change to ``csrc/dw_stage.cuh`` or
``dwconv_ln.cuh``: it builds both trees' ``dwconv_ln.cu`` (#2),
``block_train_bwd.cu`` (#10), ``dwconv_bwd.cu`` (#3, #4) and the wgmma
libraries ``convnext_block.cu``, ``row_mlp.cu`` and ``ln_mlp_bwd.cu``, whose
SASS must match the parent's kernel for kernel (it raises otherwise); then
#10 at the train step's shapes (a parent with #10's first tap-sum form gets
that form's workspace), #2 at the all-kernel step's four shapes and
inference's B16 16x16 C = 1024, and #4 and #3 as the ``dwconv_bwd`` case
times them, each through its own build's C interface, parent, tree, tree,
parent, each build's call split into its kernels (a profile).

``DIR`` is a checkout of another commit (``git archive``). The sources are
compiled by nvcc with the package's flags, and ``cuobjdump`` lists their
SASS; kernels are matched by name, the default activation of
``csrc/mlp_body.cuh`` (``GeluTanh``) left out, and a kernel that gained its
element type as a first template argument matched in bf16 to its form
without it (``block_prologue<__nv_bfloat16, 128, false>`` is
``block_prologue<128, false>``, ``wg_gemm<__nv_bfloat16, 1, 2, false, 4>``
``wg_gemm<1, 2, false, 4>``). A tree whose entry points take the element
type (``int dtype``) is called with 0, bf16, and one whose entry points take
the f32 K plan (``plan``, and the forwards' ``ws``) with nulls; f32 kernels
(an f32 first template argument, the SIMT core's ``f32_gemm``, the K
splits' ``split_reduce``) in either build are listed, and do not count as
kernels that moved. Where two kernels' SASS
differs, the script says whether the instructions differ only in their
control bits, only in their operands (registers), or in their opcodes.
Times: each build's device
time a launch (a CUDA graph of back-to-back launches), its time a launch
enqueued from the host back to back and the host's time a launch (both by
:func:`~spine_vision_torch.probes.time_ms`), in the order parent, tree, tree,
parent; then #5's own wrapper (``ops/fused_mlp.py::mlp_fwd``), 20 calls back
to back as ``chip_smoke.py`` times it. The outputs of #5, #7 and #1 must
agree within 1e-2 of max |parent| between the builds (a kernel whose form
changed sums its products in another order); the line says where they agree
bit for bit. Runs on the card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from spine_vision_torch.ops import cuda_build
from spine_vision_torch.probes import SEED, normal, time_ms

# The sources of #1, #5 and #7: the row forms (#5, #7) moved from
# convnext_block.cu to row_mlp.cu when #1 moved to wgmma products; each tree
# builds whichever of the two it has.
SOURCES = ("convnext_block", "row_mlp")
ENTRY = {"mlp_fwd": "svt_mlp_forward", "ln_mlp": "svt_ln_mlp_forward",
         "convnext_block_emit_conv": "svt_convnext_block_forward"}
STAGES = ((32, 128), (16, 256), (8, 512))  # #5's path: B2 at 128^2, H = W of each C
TRAIN_STAGES = ((128, 128), (64, 256), (32, 512))  # the train step: B32 at 512^2
# (kernel, batch, stages, launches a timed run): #5 at its path's shapes; #7
# and #1's training form at the train step's.
CASES = (("mlp_fwd", 2, STAGES, 200), ("ln_mlp", 32, TRAIN_STAGES, 20),
         ("convnext_block_emit_conv", 32, TRAIN_STAGES, 20))
_ANON = re.compile(r"\(anonymous namespace\)::")
# Kernels that gained their element type as a first template argument.
_RETYPED = re.compile(r"^(block_prologue|mlp_ln_rows|bwd_rows|ln_rows_bwd|tap_sums|wg_gemm)"
                      r"<__nv_bfloat16, ")
_ENCODING = re.compile(r"/\* (0x[0-9a-f]{16}) \*/")


def _build(csrc: Path, out: Path, source: str) -> subprocess.Popen:
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
                             str(csrc / f"{source}.cu")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _tool(name: str) -> str:
    found = Path(cuda_build._nvcc()).parent / name
    if found.exists():
        return str(found)
    other = shutil.which(name)
    if other is None:
        raise RuntimeError(f"{name} not found beside nvcc or on PATH")
    return other


def _demangle(names: list[str]) -> dict[str, str]:
    """Mangled name -> ``kernel<args>`` without namespace, parameters or the
    default activation."""
    filt = shutil.which("c++filt") or _tool("cu++filt")
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    plain = [_ANON.sub("", n).removeprefix("void ").split("(")[0].replace(", GeluTanh>", ">")
             for n in out]
    plain = [_RETYPED.sub(r"\1<", n).replace("reduce_rows<__nv_bfloat16>", "reduce_rows")
             for n in plain]
    return dict(zip(names, plain, strict=True))


def _f32_form(kernel: str) -> bool:
    """Whether ``kernel`` is an f32 form, which a bf16-only tree lacks and
    whose core the trees may differ in."""
    return ("f32_gemm<" in kernel or "split_reduce<" in kernel or "<float," in kernel
            or kernel == "reduce_rows<float>")


def _typed(csrc: Path, source: str) -> bool:
    """Whether the tree at ``csrc``'s entry points in ``source`` take the
    element type (``int dtype``)."""
    path = csrc / f"{source}.cu"
    return path.exists() and "int dtype" in path.read_text()


def _planned(csrc: Path, source: str) -> bool:
    """Whether the tree at ``csrc``'s entry points in ``source`` take the f32
    K plan (``const long long* plan``)."""
    path = csrc / f"{source}.cu"
    return path.exists() and "const long long* plan" in path.read_text()


def _sass(lib: Path) -> dict[str, list[tuple[str, str]]]:
    """Kernel -> its instructions, each ``(text, encoding)``: the text
    without its address, the encoding's words (which hold the control bits)."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    bodies: dict[str, list[list[str]]] = {}
    name = None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            bodies[name] = []
        elif name is not None and ";" in line:
            inst = re.sub(r"/\*[0-9a-f]{4}\*/", "", line.split(";")[0]).strip()
            bodies[name].append([inst, " ".join(_ENCODING.findall(line))])
        elif name is not None and bodies[name] and _ENCODING.search(line):
            bodies[name][-1][1] += " " + " ".join(_ENCODING.findall(line))
    names = _demangle(list(bodies))
    return {names[k]: [tuple(i) for i in v] for k, v in bodies.items()}


def kernel_names(lib: Path) -> set[str]:
    """The kernels of a built library, as ``kernel<args>``."""
    return set(_sass(lib))


def _opcode(inst: str) -> str:
    words = inst.split()
    return words[1] if words and words[0].startswith("@") else (words[0] if words else "")


def _compare(a: list[tuple[str, str]], b: list[tuple[str, str]]) -> str:
    """How two kernels' instruction lists differ."""
    if a == b:
        return f"SASS identical ({len(a)} instructions)"
    if len(a) != len(b):
        return f"SASS differs: {len(a)} / {len(b)} instructions"
    ops = sum(_opcode(x[0]) != _opcode(y[0]) for x, y in zip(a, b))
    operands = sum(x[0] != y[0] for x, y in zip(a, b))
    control = sum(x != y for x, y in zip(a, b))
    first = [f"{x[0]} / {y[0]}" for x, y in zip(a, b) if x[0] != y[0]][:3]
    return (f"SASS differs: {len(a)} instructions each, {control} with other encodings, "
            f"{operands} with other text, {ops} with other opcodes"
            + (f" (first: {' | '.join(first)})" if first else ""))


def _resources(lib: Path) -> dict[str, tuple[int, int]]:
    """Kernel -> (registers, stack bytes), from ``cuobjdump -res-usage``."""
    text = subprocess.run([_tool("cuobjdump"), "-res-usage", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    found, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
        elif name is not None and "REG:" in line:
            regs = int(re.search(r"REG:(\d+)", line).group(1))
            stack = int(re.search(r"STACK:(\d+)", line).group(1))
            found[name] = (regs, stack)
            name = None
    names = _demangle(list(found))
    return {names[k]: v for k, v in found.items()}


def _inputs(b: int, hw: int, c: int, device) -> dict:
    rng = np.random.default_rng(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    return {
        "x": normal(rng, (b, hw, hw, c), 0.5, bf16, device),
        "res": normal(rng, (b, hw, hw, c), 0.5, bf16, device),
        "k49": normal(rng, (49, c), 1 / 7, bf16, device),
        "dw_bias": normal(rng, (c,), 0.01, f32, device),
        "ln_scale": (1.0 + normal(rng, (c,), 0.1, f32, device)).contiguous(),
        "ln_bias": normal(rng, (c,), 0.1, f32, device),
        "w1t": normal(rng, (4 * c, c), c ** -0.5, bf16, device),
        "b1": normal(rng, (4 * c,), 0.01, f32, device),
        "w2t": normal(rng, (c, 4 * c), (4 * c) ** -0.5, bf16, device),
        "b2": normal(rng, (c,), 0.01, f32, device),
        "gamma": (1.0 + normal(rng, (c,), 0.1, f32, device)).contiguous(),
    }


def _scratch(csrc: Path) -> dict[str, tuple[str, ...]]:
    """The scratch each entry point of the tree at ``csrc`` takes after its
    outputs, by its kernels: #1's wgmma form (``block_prologue``) y [M, C]
    and h [M, 4C]; the row forms' (``mlp_ln_rows``) #7 y and h, #5 h. The
    mma.sync forms take none, e.g.
      int svt_convnext_block_forward(x, k, dw_bias, ln_scale, ln_bias, w1t, b1,
                                     w2t, b2, gamma, out, t, int B, int H,
                                     int W, int C, float eps, void* stream)"""
    def has(source: str, kernel: str) -> bool:
        path = csrc / f"{source}.cu"
        return path.exists() and kernel in path.read_text()

    rows = has("row_mlp", "mlp_ln_rows")
    return {"convnext_block_emit_conv": ("y", "h") if has("convnext_block", "block_prologue")
            else (), "ln_mlp": ("y", "h") if rows else (), "mlp_fwd": ("h",) if rows else ()}


def _launcher(tag: str, kernel: str, lib: ctypes.CDLL, scratch_names: tuple[str, ...], a: dict,
              outs: tuple[torch.Tensor, ...], typed: bool = False, planned: bool = False):
    """One launch of the ``tag`` build's ``kernel`` from ``lib`` on ``a``,
    into ``outs``, with the scratch its interface takes (and, ``typed``, the
    element type, bf16; ``planned``, null f32 workspace and plan)."""
    p = cuda_build.ptr
    b, h, w, c = a["x"].shape
    m = ctypes.c_longlong(b * h * w)
    eps = ctypes.c_float(1e-6)
    mlp = (p(a["w1t"]), p(a["b1"]), p(a["w2t"]), p(a["b2"]), p(a["gamma"]))
    widths = {"y": c, "h": 4 * c}
    scratch = [torch.empty(b * h * w, widths[n], dtype=torch.bfloat16, device=a["x"].device)
               for n in scratch_names]
    none = ctypes.c_void_p(None)
    mid = (tuple(p(v) for v in scratch) + ((none, none) if planned else ())
           + ((ctypes.c_int(0),) if typed else ()))
    if kernel == "mlp_fwd":
        fn = lib.svt_mlp_forward
        args = (p(a["x"]), p(a["res"]), *mlp, p(outs[0]), *mid, m, ctypes.c_int(c))
    elif kernel == "ln_mlp":
        fn = lib.svt_ln_mlp_forward
        args = (p(a["x"]), p(a["res"]), p(a["ln_scale"]), p(a["ln_bias"]), *mlp, p(outs[0]),
                *mid, m, ctypes.c_int(c), eps)
    else:
        fn = lib.svt_convnext_block_forward
        args = (p(a["x"]), p(a["k49"]), p(a["dw_bias"]), p(a["ln_scale"]), p(a["ln_bias"]), *mlp,
                p(outs[0]), p(outs[1]), *mid, *(ctypes.c_int(v) for v in (b, h, w, c)), eps)
    outs = (*outs, *scratch)  # kept alive with the launch
    fn.restype = ctypes.c_int

    def launch():
        cuda_build.check(fn(*args, cuda_build.stream_ptr(outs[0].device)), f"{tag} {kernel}")

    return launch


def _holding(loaded: dict, tag: str, entry: str) -> ctypes.CDLL:
    """The ``tag`` build's library that exports ``entry``."""
    for (t, _), lib in loaded.items():
        if t == tag and hasattr(lib, entry):
            return lib
    raise RuntimeError(f"no library of the {tag}'s build exports {entry}")


def _device_ms(launch, launches: int) -> float:
    """Device time a launch: the best of three replays of a graph of
    ``launches`` launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            launch()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / launches)
    return best


BWD_SOURCES = {"ln_mlp_bwd": "ln_mlp_bwd", "mlp_bwd": "ln_mlp_bwd",
               "block_train_bwd": "block_train_bwd"}


def _spills(log: str) -> int:
    return sum(int(line.split()[4]) for line in log.splitlines() if "spill stores" in line)


def _legacy_rows_per_cta(rows: int, c: int) -> int:
    """Image rows each CTA of #10's first tap-sum form (``tap_sums`` on a
    channel group and a run of the B * H rows) walked: about 2048 CTAs over
    the 64-channel groups and the rows. Its workspace has ceil(B * H / rows)
    rows."""
    groups = -(-c // 64)
    return -(-rows // max(1, -(-2048 // groups)))


def _tap_rows(b: int, h: int, w: int, c: int, legacy: bool) -> tuple[int, int]:
    """#10's int argument and its tap workspace's rows: the first form's
    rows a CTA of the B * H rows, or ``block_train.tap_geometry``'s rows a
    run and parts."""
    from spine_vision_torch.ops import block_train as bt

    if legacy:
        rows = _legacy_rows_per_cta(b * h, c)
        return rows, -(-(b * h) // rows)
    geo = bt.tap_geometry(b, h, w, c)
    return geo["rows_per_run"], geo["parts"]


def _bwd_launcher(tag: str, lib: ctypes.CDLL, kernel: str, a: dict, legacy: bool = False,
                  typed: bool = True, planned: bool = False):
    """One call of the ``tag`` build's ``kernel`` (ln_mlp_bwd, mlp_bwd or
    block_train_bwd) on ``a``, into fresh outputs and scratch: ``(launch,
    outputs)``. Both builds take this tree's C interface, with the element
    type (bf16) where ``typed`` and a null f32 K plan where ``planned``; with
    ``legacy``, #10's tap sums are the first form's (:func:`_tap_rows`)."""
    from spine_vision_torch.ops import fused_mlp as fm

    t, g = a["x"], a["res"]
    b, h, w, c = t.shape
    m = b * h * w
    ln = kernel != "mlp_bwd"
    dev, f32 = t.device, torch.float32
    p = cuda_build.ptr
    o = {"dt": torch.empty_like(t), "small": torch.empty(8 * c, dtype=f32, device=dev),
         "dw1t": torch.empty(4 * c, c, dtype=f32, device=dev),
         "dw2t": torch.empty(c, 4 * c, dtype=f32, device=dev),
         "dgamma": torch.empty(c, dtype=f32, device=dev)}
    w1, w2 = a["w1t"].t().contiguous(), a["w2t"].t().contiguous()
    weights = (p(a["w1t"]), p(w1), p(a["b1"]), p(a["w2t"]), p(w2), p(a["b2"]), p(a["gamma"]))
    geo = fm.bwd_geometry(m, c)
    k = fm._buffers(t, ln, geo)
    mid = ((p(k["y"]),) if ln else ()) + (p(k["gg"]),) + ((p(k["stats"]),) if ln else ()) + (
        p(k["h"]), p(k["gh"])) + ((p(k["gy"]),) if ln else ())
    split = (ctypes.c_int(geo["splits"]), ctypes.c_longlong(geo["ks"])) + (
        (ctypes.c_void_p(None),) if planned else ())
    outs = (p(o["dt"]), p(o["small"]), p(o["dw1t"]), p(o["dw2t"]), p(o["dgamma"]))
    tail = (p(k["part"]), p(k["ws"]))
    dtype = (ctypes.c_int(0),) if typed else ()
    if kernel == "block_train_bwd":
        rows, parts = _tap_rows(b, h, w, c, legacy)
        o["taps"] = torch.empty(50 * c, dtype=f32, device=dev)
        k["u"] = torch.empty(m, c, dtype=f32, device=dev)
        k["gu32"] = torch.empty(m, c, dtype=f32, device=dev)
        k["tpart"] = torch.empty(parts, 50 * c, dtype=f32, device=dev)
        fn = lib.svt_block_train_bwd
        args = (p(t), p(a["k49"]), p(a["dw_bias"]), p(a["ln_scale"]), p(a["ln_bias"]), *weights,
                p(g), *outs, p(o["taps"]), p(k["u"]), p(k["gu32"]), *mid, *tail, p(k["tpart"]),
                *dtype, *(ctypes.c_int(v) for v in (b, h, w, c)), *split, ctypes.c_int(rows),
                ctypes.c_float(1e-6))
    elif ln:
        fn = lib.svt_ln_mlp_bwd
        args = (p(t), p(g), p(a["ln_scale"]), p(a["ln_bias"]), *weights, *outs, *mid, *tail,
                *dtype, ctypes.c_longlong(m), ctypes.c_int(c), *split)
    else:
        fn = lib.svt_mlp_bwd
        args = (p(t), p(g), *weights, *outs, *mid, *tail, *dtype, ctypes.c_longlong(m),
                ctypes.c_int(c), *split)
    fn.restype = ctypes.c_int
    keep = (k, w1, w2)

    def launch():
        cuda_build.check(fn(*args, cuda_build.stream_ptr(dev)), f"{tag} {kernel}")
        return keep

    return launch, o


def _build_pair(parent: Path, sources) -> tuple[dict, dict]:
    """Both trees' builds of each of ``sources``: each build's kernels with
    their registers, stack and spills, then each source's SASS compared,
    printed. Returns the libraries by (source, tag) and, by source, the
    kernels whose SASS differs or that only one build has."""
    libs, jobs = {}, {}
    for source in sources:
        for tag, csrc in (("parent", parent / "spine_vision_torch" / "csrc"),
                          ("tree", cuda_build.CSRC)):
            libs[source, tag] = cuda_build.BUILD_DIR / "build_diff" / f"lib{source}-{tag}.so"
            jobs[source, tag] = _build(csrc, libs[source, tag], source)
    for (source, tag), job in jobs.items():
        log, _ = job.communicate()
        if job.returncode:
            raise RuntimeError(f"nvcc failed for the {tag}'s {source}.cu:\n{log}")
        res = _resources(libs[source, tag])
        print(f"[build_diff] {source} {tag}: {len(res)} kernels, spill stores {_spills(log)} "
              f"bytes; registers / stack bytes: " + "; ".join(
                  f"{name} {r} / {st}" for name, (r, st) in sorted(res.items())))
    moved = {}
    for source in sources:
        sass = {tag: _sass(libs[source, tag]) for tag in ("parent", "tree")}
        shared = sorted(set(sass["parent"]) & set(sass["tree"]))
        verdicts = {k: _compare(sass["parent"][k], sass["tree"][k]) for k in shared}
        same = [k for k, v in verdicts.items() if v.startswith("SASS identical")]
        only = {tag: sorted(set(sass[tag]) - set(sass[other])) for tag, other in
                (("parent", "tree"), ("tree", "parent"))}
        print(f"[build_diff] {source}: {len(shared)} kernels in both builds, {len(same)} with "
              f"identical SASS (parent / tree); only in the parent's: {only['parent'] or 'none'}"
              f"; only in the tree's: {only['tree'] or 'none'}" + "".join(
                  f"; {k}: {v}" for k, v in verdicts.items() if k not in same))
        moved[source] = (sorted(set(verdicts) - set(same))
                         + [k for k in only["parent"] + only["tree"] if not _f32_form(k)])
    return libs, moved


def _legacy_taps(parent: Path) -> bool:
    """Whether the tree at ``parent`` has #10's first tap-sum form."""
    src = parent / "spine_vision_torch" / "csrc" / "block_train_bwd.cu"
    return "conv_bias_f32" in src.read_text()


def _bwd_case(parent: Path, dev) -> None:
    """The ``ln_mlp_bwd`` case: both builds of csrc/ln_mlp_bwd.cu and of
    csrc/block_train_bwd.cu, which includes its header."""
    libs, _ = _build_pair(parent, sorted(set(BWD_SOURCES.values())))
    loaded = {key: ctypes.CDLL(str(lib)) for key, lib in libs.items()}
    legacy = _legacy_taps(parent)
    trees = {"parent": parent / "spine_vision_torch" / "csrc", "tree": cuda_build.CSRC}
    for kernel, source in BWD_SOURCES.items():
        for hw, c in TRAIN_STAGES:
            a = _inputs(32, hw, c, dev)
            runs = {tag: _bwd_launcher(tag, loaded[source, tag], kernel, a,
                                       legacy and tag == "parent", _typed(csrc, source),
                                       _planned(csrc, source))
                    for tag, csrc in trees.items()}
            rows = [(tag, _device_ms(runs[tag][0], 10)) for tag in
                    ("parent", "tree", "tree", "parent")]
            torch.cuda.synchronize()
            errs = {}
            for name, want in runs["parent"][1].items():
                got = runs["tree"][1][name]
                errs[name] = ((got.float() - want.float()).abs().max()
                              / want.float().abs().max().clamp_min(1e-6)).item()
            print(f"[build_diff] {kernel} B=32 {hw}x{hw} C={c}: " + "; ".join(
                f"{tag} device {d:.4f}" for tag, d in rows) + " ms a call; tree against parent, "
                "max |diff| / max |parent|: " + " ".join(f"{n}={e:.3g}" for n, e in errs.items()))
            if max(errs.values()) > 2e-2:
                raise AssertionError(f"the two builds' {kernel} outputs differ at C={c}: {errs}")
            del a, runs
            torch.cuda.empty_cache()


# The dwconv_bwd case: #4 and #3's source, and the sources whose SASS must not
# move with it alone (they share its headers; a change to dw_stage.cuh moves
# dwconv_ln.cu and block_train_bwd.cu too: the dw_fwd case).
DW_SOURCES = ("dwconv_bwd", "dwconv_ln", "convnext_block", "block_train_bwd")
DW_KEPT = DW_SOURCES[1:]
DW_STAGES = TRAIN_STAGES + ((16, 1024),)  # the all-kernel step's four widths


def _dw_launchers(tag: str, lib: ctypes.CDLL, legacy: bool, a: dict) -> dict:
    """#4 (``svt_dw_ln_bwd``) and #3 (``svt_dwconv7x7`` on x with the flipped
    filter) of the ``tag`` build on ``a``, each ``(launch, outputs)``. Both
    builds' C interfaces take the same arguments; the workspace differs: the
    warp-per-token form (``legacy``) walks :func:`_legacy_rows_per_cta` rows
    of the B * H rows a CTA, the Hopper form ``dwconv.bwd_geometry``'s runs."""
    from spine_vision_torch.ops import dwconv as dw

    x, g = a["x"], a["res"]
    b, h, w, c = x.shape
    dev, f32 = x.device, torch.float32
    if legacy:
        rows = _legacy_rows_per_cta(b * h, c)
        parts = -(-(b * h) // rows)
    else:
        geo = dw.bwd_geometry(b, h, w, c, x.dtype)
        rows, parts = geo["rows_per_run"], geo["parts"]
    o = {"da": torch.empty_like(x), "sums": torch.empty(52 * c, dtype=f32, device=dev)}
    scratch = (torch.empty(b * h * w, 4, dtype=f32, device=dev),
               torch.empty(parts, 52 * c, dtype=f32, device=dev))
    kf = a["k49"].flip(0).contiguous()
    dx = {"dx": torch.empty_like(x)}
    p = cuda_build.ptr
    bwd, sten = lib.svt_dw_ln_bwd, lib.svt_dwconv7x7
    bwd.restype = sten.restype = ctypes.c_int
    shape = tuple(ctypes.c_int(v) for v in (b, h, w, c))
    bwd_args = (p(x), p(a["k49"]), p(a["dw_bias"]), p(a["ln_scale"]), p(g), p(scratch[0]),
                p(o["da"]), p(scratch[1]), p(o["sums"]), ctypes.c_int(0), *shape,
                ctypes.c_int(rows), ctypes.c_float(1e-6))
    sten_args = (p(x), p(kf), p(dx["dx"]), ctypes.c_int(0), *shape)

    def launch_bwd():
        cuda_build.check(bwd(*bwd_args, cuda_build.stream_ptr(dev)), f"{tag} dw_ln_bwd")
        return scratch

    def launch_sten():
        cuda_build.check(sten(*sten_args, cuda_build.stream_ptr(dev)), f"{tag} dwconv7x7")
        return kf

    return {"dw_ln_bwd": (launch_bwd, o), "depthwise_conv7x7": (launch_sten, dx)}


def _launch_split(launch, calls: int = 5) -> str:
    """Device ms a call of each kernel that ``launch`` runs, by name, from a
    profile of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            launch()
        torch.cuda.synchronize()
    ms: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = _ANON.sub("", e.key).removeprefix("void ").split("(")[0].split("<")[0]
        us = getattr(e, "self_device_time_total", 0) or e.self_cuda_time_total
        ms[name.split("::")[-1]] = ms.get(name.split("::")[-1], 0.0) + us / calls / 1e3
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(ms.items()))


def _dw_case(parent: Path, dev) -> None:
    """The ``dwconv_bwd`` case: both trees' builds of #4 and #3's source and
    of the sources that share its headers, whose SASS must be the parent's;
    #4 and #3 at the all-kernel step's shapes from both builds."""
    libs, moved = _build_pair(parent, DW_SOURCES)
    for source in DW_KEPT:
        if moved[source]:
            raise AssertionError(f"{source}.cu's kernels moved with dwconv_bwd.cu: "
                                 f"{moved[source]}")
    legacy = "dw_ln_bwd_tile" in (parent / "spine_vision_torch" / "csrc" /
                                  "dwconv_bwd.cu").read_text()
    _dw_bwd_times(libs, legacy, dev)


def _compare_runs(kernel: str, shape: str, runs: dict, tol: float) -> None:
    """Time ``runs[tag] = (launch, outputs)`` of both builds in the order
    parent, tree, tree, parent (device ms a call), hold the tree's outputs
    within ``tol`` of max |parent| and print the line, with each build's call
    split into its kernels."""
    rows = [(tag, _device_ms(runs[tag][0], 10)) for tag in ("parent", "tree", "tree", "parent")]
    torch.cuda.synchronize()
    errs = {}
    for name, want in runs["parent"][1].items():
        got = runs["tree"][1][name]
        errs[name] = ((got.float() - want.float()).abs().max()
                      / want.float().abs().max().clamp_min(1e-6)).item()
    print(f"[build_diff] {kernel} {shape}: " + "; ".join(
        f"{tag} device {d:.4f}" for tag, d in rows) + " ms a call; tree against parent, "
        "max |diff| / max |parent|: " + " ".join(f"{n}={e:.3g}" for n, e in errs.items())
        + f" (tol {tol}); launches, device ms a call: " + "; ".join(
            f"{tag} {_launch_split(runs[tag][0])}" for tag in ("parent", "tree")))
    if max(errs.values()) > tol:
        raise AssertionError(f"the two builds' {kernel} outputs differ at {shape}: {errs}")


def _dw_bwd_times(libs: dict, legacy: bool, dev) -> None:
    """#4 and #3 at the all-kernel step's four shapes from both builds of
    dwconv_bwd.cu (:func:`_compare_runs`)."""
    for hw, c in DW_STAGES:
        a = _inputs(32, hw, c, dev)
        runs = {tag: _dw_launchers(tag, ctypes.CDLL(str(libs["dwconv_bwd", tag])),
                                   legacy and tag == "parent", a) for tag in ("parent", "tree")}
        for kernel, tol in (("dw_ln_bwd", 2e-2), ("depthwise_conv7x7", 1e-2)):
            _compare_runs(kernel, f"B=32 {hw}x{hw} C={c}",
                          {tag: runs[tag][kernel] for tag in runs}, tol)
        del a, runs
        torch.cuda.empty_cache()


# The dw_fwd case: #2's and #10's sources, #3 and #4's (whose stencil and S
# gained epilogues), and the wgmma libraries, whose SASS must not move (they
# include dwconv_ln.cuh through wg_gemm.cuh).
FWD_SOURCES = ("dwconv_ln", "block_train_bwd", "dwconv_bwd", "convnext_block", "row_mlp",
               "ln_mlp_bwd")
FWD_KEPT = ("convnext_block", "row_mlp", "ln_mlp_bwd")
DW_LN_STAGES = tuple((32, hw, c) for hw, c in DW_STAGES) + ((16, 16, 1024),)


def _dw_ln_launcher(tag: str, lib: ctypes.CDLL, a: dict):
    """#2 (``svt_dw_ln_forward``, bf16) of the ``tag`` build on ``a``:
    ``(launch, outputs)``."""
    x = a["x"]
    b, h, w, c = x.shape
    o = {"y": torch.empty_like(x)}
    p = cuda_build.ptr
    fn = lib.svt_dw_ln_forward
    fn.restype = ctypes.c_int
    args = (p(x), p(a["k49"]), p(a["dw_bias"]), p(a["ln_scale"]), p(a["ln_bias"]), p(o["y"]),
            ctypes.c_int(0), *(ctypes.c_int(v) for v in (b, h, w, c)), ctypes.c_float(1e-6))

    def launch():
        cuda_build.check(fn(*args, cuda_build.stream_ptr(x.device)), f"{tag} dw_ln")

    return launch, o


def _fwd_case(parent: Path, dev) -> None:
    """The ``dw_fwd`` case: both trees' builds of #2's, #10's and #3/#4's
    sources and of the wgmma libraries, whose SASS must be the parent's; #10
    and #3/#4 at the train step's shapes and #2 at those and inference's,
    from both builds."""
    libs, moved = _build_pair(parent, FWD_SOURCES)
    for source in FWD_KEPT:
        if moved[source]:
            raise AssertionError(f"{source}.cu's kernels moved: {moved[source]}")
    loaded = {key: ctypes.CDLL(str(lib)) for key, lib in libs.items()}
    legacy = _legacy_taps(parent)
    trees = {"parent": parent / "spine_vision_torch" / "csrc", "tree": cuda_build.CSRC}
    for hw, c in TRAIN_STAGES:
        a = _inputs(32, hw, c, dev)
        runs = {tag: _bwd_launcher(tag, loaded["block_train_bwd", tag], "block_train_bwd", a,
                                   legacy and tag == "parent", _typed(csrc, "block_train_bwd"),
                                   _planned(csrc, "block_train_bwd"))
                for tag, csrc in trees.items()}
        _compare_runs("block_train_bwd", f"B=32 {hw}x{hw} C={c}", runs, 2e-2)
        del a, runs
        torch.cuda.empty_cache()
    for b, hw, c in DW_LN_STAGES:
        a = _inputs(b, hw, c, dev)
        runs = {tag: _dw_ln_launcher(tag, loaded["dwconv_ln", tag], a)
                for tag in ("parent", "tree")}
        _compare_runs("dw_ln", f"B={b} {hw}x{hw} C={c}", runs, 1e-2)
        del a, runs
        torch.cuda.empty_cache()
    _dw_bwd_times(libs, False, dev)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, type=Path,
                        help="checkout of the commit to compare with")
    parser.add_argument("--case", choices=("convnext_block", "ln_mlp_bwd", "dwconv_bwd",
                                           "dw_fwd"),
                        default="convnext_block", help="the source to build from both trees")
    args = parser.parse_args(argv)
    from spine_vision_torch.device import resolve_device
    from spine_vision_torch.ops import fused_mlp as fm

    dev = resolve_device("cuda")
    if args.case == "ln_mlp_bwd":
        _bwd_case(args.parent, dev)
        return 0
    if args.case == "dwconv_bwd":
        _dw_case(args.parent, dev)
        return 0
    if args.case == "dw_fwd":
        _fwd_case(args.parent, dev)
        return 0
    trees = {"parent": args.parent / "spine_vision_torch" / "csrc", "tree": cuda_build.CSRC}
    libs, jobs = {}, {}
    for tag, csrc in trees.items():
        for source in SOURCES:
            if (csrc / f"{source}.cu").exists():
                libs[tag, source] = cuda_build.BUILD_DIR / "build_diff" / f"lib{source}-{tag}.so"
                jobs[tag, source] = _build(csrc, libs[tag, source], source)
    for (tag, source), job in jobs.items():
        log, _ = job.communicate()
        if job.returncode:
            raise RuntimeError(f"nvcc failed for the {tag}'s {source}.cu:\n{log}")

    sass = {tag: {} for tag in trees}
    res = {tag: {} for tag in trees}
    for (tag, _), lib in libs.items():
        sass[tag].update(_sass(lib))
        res[tag].update(_resources(lib))
    for tag, other in (("parent", "tree"), ("tree", "parent")):
        only = sorted(set(sass[tag]) - set(sass[other]))
        if tag == "tree":
            print(f"[build_diff] of those only in the tree's build, f32 forms: "
                  f"{sum(_f32_form(k) for k in only)}")
        print(f"[build_diff] {len(only)} kernels only in the {tag}'s build" +
              "".join(f"; {k} (registers {res[tag][k][0]}, stack {res[tag][k][1]} bytes)"
                      for k in only))
    shared = sorted(set(sass["parent"]) & set(sass["tree"]))
    identical = 0
    for kernel in shared:
        verdict = _compare(sass["parent"][kernel], sass["tree"][kernel])
        identical += verdict.startswith("SASS identical")
        (rp, sp), (rt, st) = res["parent"][kernel], res["tree"][kernel]
        print(f"[build_diff] {kernel}: registers {rp} / {rt}, stack {sp} / {st} bytes, {verdict}")
    print(f"[build_diff] {len(shared)} kernels in both builds, {identical} with identical SASS "
          "(parent / tree)")

    loaded = {key: ctypes.CDLL(str(lib)) for key, lib in libs.items()}
    scratch = {tag: _scratch(csrc) for tag, csrc in trees.items()}
    typed = {tag: _typed(csrc, "convnext_block") for tag, csrc in trees.items()}
    planned = {tag: _planned(csrc, "convnext_block") for tag, csrc in trees.items()}
    for kernel, batch, stages, launches in CASES:
        for hw, c in stages:
            a = _inputs(batch, hw, c, dev)
            n_out = 2 if kernel == "convnext_block_emit_conv" else 1
            outs = {tag: tuple(torch.empty_like(a["x"]) for _ in range(n_out)) for tag in trees}
            launch = {tag: _launcher(tag, kernel, _holding(loaded, tag, ENTRY[kernel]),
                                     scratch[tag][kernel], a, outs[tag], typed[tag],
                                     planned[tag])
                      for tag in trees}
            rows = []
            for tag in ("parent", "tree", "tree", "parent"):
                rows.append((tag, _device_ms(launch[tag], launches),
                             *time_ms(launch[tag], iters=launches)))
            torch.cuda.synchronize()
            pairs = list(zip(outs["parent"], outs["tree"]))
            errs = [((y.float() - x.float()).abs().max() / x.float().abs().max()).item()
                    for x, y in pairs]
            equal = max(errs) <= 1e-2
            verdict = ("within" if equal else "NOT within") + " 1e-2 of max |parent| (" + \
                ", ".join(f"{n} {e:.3g}" for n, e in zip(("out", "t"), errs)) + ")" + (
                    ", bit for bit" if all(torch.equal(x, y) for x, y in pairs) else "")
            line = (f"[build_diff] {kernel} B={batch} {hw}x{hw} C={c}: " + "; ".join(
                f"{tag} device {d:.4f} enqueued {e:.4f} host {h:.4f}" for tag, d, e, h in rows)
                + f" ms a launch; outputs {verdict}")
            if kernel == "mlp_fwd":
                x2 = a["x"].view(-1, c)
                wrapped = time_ms(lambda: fm.mlp_fwd(x2, a["w1t"], a["b1"], a["w2t"], a["b2"],
                                                          a["gamma"], a["res"].view(-1, c)))
                line += (f"; the package wrapper {wrapped[0]:.4f} ms a call enqueued, host "
                         f"{wrapped[1]:.4f}")
            print(line)
            if not equal:
                raise AssertionError(f"the two builds' {kernel} outputs differ at C={c}")
            del a, outs, launch
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
