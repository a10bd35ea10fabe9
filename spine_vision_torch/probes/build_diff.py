"""Hold this tree's build of ``csrc/convnext_block.cu`` against another
tree's: the SASS of every kernel, each kernel's registers and stack, and the
time of #5 (``svt_mlp_forward``) at the shapes of its path, #7
(``svt_ln_mlp_forward``) and #1 in its training form
(``svt_convnext_block_forward`` with t) at the train step's, launched from
each build in turn.

    python -m spine_vision_torch.probes.build_diff --parent DIR

``DIR`` is a checkout of another commit (``git archive``). Both sources are
compiled by nvcc with the package's flags, and ``cuobjdump`` lists their
SASS; kernels are matched by name, the default activation of
``csrc/mlp_body.cuh`` (``GeluTanh``) left out. Where two kernels' SASS
differs, the script says whether the instructions differ only in their
control bits, only in their operands (registers), or in their opcodes.
Times: each build's device
time a launch (a CUDA graph of back-to-back launches), its time a launch
enqueued from the host back to back and the host's time a launch (both by
:func:`~spine_vision_torch.probes.time_ms`), in the order parent, tree, tree,
parent; then #5's own wrapper (``ops/fused_mlp.py::mlp_fwd``), 20 calls back
to back as ``chip_smoke.py`` times it. Runs on the card.
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

SOURCE = "convnext_block"
STAGES = ((32, 128), (16, 256), (8, 512))  # #5's path: B2 at 128^2, H = W of each C
TRAIN_STAGES = ((128, 128), (64, 256), (32, 512))  # the train step: B32 at 512^2
# (kernel, batch, stages, launches a timed run): #5 at its path's shapes; #7
# and #1's training form at the train step's.
CASES = (("mlp_fwd", 2, STAGES, 200), ("ln_mlp", 32, TRAIN_STAGES, 20),
         ("convnext_block_emit_conv", 32, TRAIN_STAGES, 20))
_ANON = re.compile(r"\(anonymous namespace\)::")
_ENCODING = re.compile(r"/\* (0x[0-9a-f]{16}) \*/")


def _build(csrc: Path, out: Path) -> subprocess.Popen:
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
                             str(csrc / f"{SOURCE}.cu")], stdout=subprocess.PIPE,
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
    return dict(zip(names, plain, strict=True))


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
    return (f"SASS differs: {len(a)} instructions each, {control} with other encodings, "
            f"{operands} with other text, {ops} with other opcodes")


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


def _launcher(kernel: str, lib: ctypes.CDLL, a: dict, outs: tuple[torch.Tensor, ...]):
    """One launch of ``kernel`` from ``lib`` on ``a``, into ``outs``."""
    p = cuda_build.ptr
    b, h, w, c = a["x"].shape
    m = ctypes.c_longlong(b * h * w)
    eps = ctypes.c_float(1e-6)
    mlp = (p(a["w1t"]), p(a["b1"]), p(a["w2t"]), p(a["b2"]), p(a["gamma"]))
    if kernel == "mlp_fwd":
        fn = lib.svt_mlp_forward
        args = (p(a["x"]), p(a["res"]), *mlp, p(outs[0]), m, ctypes.c_int(c))
    elif kernel == "ln_mlp":
        fn = lib.svt_ln_mlp_forward
        args = (p(a["x"]), p(a["res"]), p(a["ln_scale"]), p(a["ln_bias"]), *mlp, p(outs[0]), m,
                ctypes.c_int(c), eps)
    else:
        fn = lib.svt_convnext_block_forward
        args = (p(a["x"]), p(a["k49"]), p(a["dw_bias"]), p(a["ln_scale"]), p(a["ln_bias"]), *mlp,
                p(outs[0]), p(outs[1]), *(ctypes.c_int(v) for v in (b, h, w, c)), eps)
    fn.restype = ctypes.c_int

    def launch():
        cuda_build.check(fn(*args, cuda_build.stream_ptr(outs[0].device)), kernel)

    return launch


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


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, type=Path,
                        help="checkout of the commit to compare with")
    args = parser.parse_args(argv)
    from spine_vision_torch.device import resolve_device
    from spine_vision_torch.ops import fused_mlp as fm

    dev = resolve_device("cuda")
    libs = {"parent": cuda_build.BUILD_DIR / "build_diff" / f"lib{SOURCE}-parent.so",
            "tree": cuda_build.BUILD_DIR / "build_diff" / f"lib{SOURCE}-tree.so"}
    jobs = {"parent": _build(args.parent / "spine_vision_torch" / "csrc", libs["parent"]),
            "tree": _build(cuda_build.CSRC, libs["tree"])}
    for tag, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode:
            raise RuntimeError(f"nvcc failed for the {tag}'s {SOURCE}.cu:\n{log}")

    sass = {tag: _sass(lib) for tag, lib in libs.items()}
    res = {tag: _resources(lib) for tag, lib in libs.items()}
    if set(sass["parent"]) != set(sass["tree"]):
        raise AssertionError(f"kernels differ: parent only {set(sass['parent']) - set(sass['tree'])}"
                             f", tree only {set(sass['tree']) - set(sass['parent'])}")
    identical = 0
    for kernel in sorted(sass["tree"]):
        verdict = _compare(sass["parent"][kernel], sass["tree"][kernel])
        identical += verdict.startswith("SASS identical")
        (rp, sp), (rt, st) = res["parent"][kernel], res["tree"][kernel]
        print(f"[build_diff] {kernel}: registers {rp} / {rt}, stack {sp} / {st} bytes, {verdict}")
    print(f"[build_diff] {SOURCE}: {len(sass['tree'])} kernels, {identical} with identical SASS "
          "(parent / tree)")

    loaded = {tag: ctypes.CDLL(str(lib)) for tag, lib in libs.items()}
    for kernel, batch, stages, launches in CASES:
        for hw, c in stages:
            a = _inputs(batch, hw, c, dev)
            n_out = 2 if kernel == "convnext_block_emit_conv" else 1
            outs = {tag: tuple(torch.empty_like(a["x"]) for _ in range(n_out)) for tag in loaded}
            launch = {tag: _launcher(kernel, lib, a, outs[tag]) for tag, lib in loaded.items()}
            rows = []
            for tag in ("parent", "tree", "tree", "parent"):
                rows.append((tag, _device_ms(launch[tag], launches),
                             *time_ms(launch[tag], iters=launches)))
            torch.cuda.synchronize()
            equal = all(torch.equal(x, y) for x, y in zip(outs["parent"], outs["tree"]))
            line = (f"[build_diff] {kernel} B={batch} {hw}x{hw} C={c}: " + "; ".join(
                f"{tag} device {d:.4f} enqueued {e:.4f} host {h:.4f}" for tag, d, e, h in rows)
                + f" ms a launch; outputs {'equal' if equal else 'DIFFER'}")
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
