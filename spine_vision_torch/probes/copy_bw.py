"""Device-memory streaming probes: what a copy reaches on this card, by
mechanism (``csrc/probe_copy.cu``).

Counterparts of ``scripts/probe_copy_bw.py`` and ``probe_copy_bw2.py`` to
``probe_copy_bw6.py``, which looked for the TPU's streaming ceiling. Each TPU
mechanism maps to the Hopper mechanism that plays its part:

- BlockSpec auto-pipelining -> :func:`copy_tiled`, plain tiled loads and
  stores, per element or 16 bytes a thread;
- a manual DMA ring through VMEM (and ``emit_pipeline``'s double buffering)
  -> :func:`copy_staged`, a cp.async ring through shared memory;
- HBM->HBM DMAs -> :func:`copy_bulk`, ``cp.async.bulk`` through shared memory
  with mbarriers (the copy engine; Hopper has no global-to-global bulk copy);
- DMA priorities -> :func:`copy_bulk_split`, two halves on CUDA streams of
  high and low priority (Hopper has no per-copy priority inside a kernel);
- read-only and write-only DMAs -> :func:`read_only`, :func:`write_only`;
- two ``pallas_call``s in flight -> :func:`inc_copy` in one launch, on two
  streams, or two launches on one stream with a data dependence.

Rates count read plus written bytes, as the scripts do, beside the share of
3.35 TB/s. Yardsticks, timed and used nowhere else: ``x.add_(1)`` (the
scripts' ``xla_inc``) and ``dst.copy_(src)``. Each wrapper launches its
kernel on a CUDA tensor and runs its plain version on a CPU tensor; its
``launches`` attribute counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from spine_vision_torch.ops import cuda_build
from spine_vision_torch.probes import SEED, Row, format_row, measure, normal

IMAGE_TOKENS = 128 * 128  # stage-1 tokens an image at 512^2
STAGES = ((128, 128), (64, 256), (32, 512), (16, 1024))  # (H = W, C) at 512^2
TILES = (256, 512, 1024, 2048, 4096)  # probe_copy_bw.py's tile_m sweep
THREADS = 256
SMEM_LIMIT = 232448  # the shared memory a block can use on an H100
READ_ONLY_WIDTHS = (64, 128, 256, 512, 1024)  # C that read_only is built for
WRITE_SLOT_ROWS = 128  # rows of the shared slot that write_only's bulk stores copy
_GRID_KIND = {"copy_staged": 0, "copy_bulk": 1, "read_only": 2, "write_only": 3}
# Runs a call of the two-stream rows (and their one-stream comparisons), so
# that one fork and join of the streams serve several kernels.
REPEATS = 10


def _fn(name: str):
    fn = getattr(cuda_build.load("probe_copy"), name)
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {t.device} and {tensors[0].device}")


@functools.lru_cache(maxsize=None)
def _grid(kind: str, threads: int, smem: int, device_index: int) -> int:
    """A persistent grid: the card's SMs times the CTAs that fit on one."""
    with torch.cuda.device(device_index):
        grid = _fn("svt_probe_grid")(_GRID_KIND[kind], threads, ctypes.c_longlong(smem))
    if grid <= 0:
        raise RuntimeError(f"{kind}: no CTA of {threads} threads and {smem} bytes fits an SM")
    return grid


def _row_bytes(x: torch.Tensor) -> int:
    return x.shape[-1] * x.element_size()


def copy_reference(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def copy_tiled(x: torch.Tensor, tile_rows: int, vector: bool = True) -> torch.Tensor:
    """``x`` [M, C] copied by ``csrc/probe_copy.cu::copy_tiled``: a CTA per
    ``tile_rows`` rows, 16 bytes a thread (``vector``) or one element."""
    if x.device.type == "cpu":
        return copy_reference(x)
    _check("copy_tiled", x)
    unit = 16 if vector else x.element_size()
    tile_bytes = tile_rows * _row_bytes(x)
    if tile_bytes % unit or x.numel() * x.element_size() % unit:
        raise ValueError(f"copy_tiled: {tile_rows} rows of {x.shape[-1]} are no whole "
                         f"{unit}-byte units")
    y = torch.empty_like(x)
    err = _fn("svt_probe_copy_tiled")(
        cuda_build.ptr(x), cuda_build.ptr(y),
        ctypes.c_longlong(x.numel() * x.element_size() // unit),
        ctypes.c_longlong(tile_bytes // unit), unit, cuda_build.stream_ptr(x.device))
    cuda_build.check(err, "copy_tiled")
    copy_tiled.launches += 1
    return y


copy_tiled.launches = 0


def copy_staged(x: torch.Tensor, slots: int, slot_rows: int) -> torch.Tensor:
    """``x`` copied through a ring of ``slots`` (2, 3, 4, 8 or 12) slots of
    ``slot_rows`` rows in shared memory, filled by cp.async, a persistent CTA
    per SM slot (``csrc/probe_copy.cu::copy_staged``)."""
    if x.device.type == "cpu":
        return copy_reference(x)
    _check("copy_staged", x)
    slot_bytes = slot_rows * _row_bytes(x)
    smem = slots * slot_bytes
    if slots not in (2, 3, 4, 8, 12) or slot_bytes % 16 or smem > SMEM_LIMIT:
        raise ValueError(f"copy_staged: {slots} slots of {slot_bytes} bytes are not built")
    y = torch.empty_like(x)
    grid = _grid("copy_staged", THREADS, smem, x.device.index or 0)
    err = _fn("svt_probe_copy_staged")(
        cuda_build.ptr(x), cuda_build.ptr(y), ctypes.c_longlong(x.numel() * x.element_size() // 16),
        slot_bytes // 16, slots, grid, cuda_build.stream_ptr(x.device))
    cuda_build.check(err, "copy_staged")
    copy_staged.launches += 1
    return y


copy_staged.launches = 0


def copy_bulk(x: torch.Tensor, slots: int, slot_rows: int,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` copied by ``cp.async.bulk`` through ``slots`` (2-16) slots of
    ``slot_rows`` rows in shared memory, issued by one thread a CTA
    (``csrc/probe_copy.cu::copy_bulk``), into ``out`` if given."""
    if x.device.type == "cpu":
        if out is None:
            return copy_reference(x)
        return out.copy_(x)
    y = torch.empty_like(x) if out is None else out
    _check("copy_bulk", x, y)
    slot_bytes = slot_rows * _row_bytes(x)
    smem = 128 + slots * slot_bytes
    if not 2 <= slots <= 16 or slot_bytes % 16 or smem > SMEM_LIMIT or y.shape != x.shape:
        raise ValueError(f"copy_bulk: {slots} slots of {slot_bytes} bytes are not built")
    grid = _grid("copy_bulk", 32, smem, x.device.index or 0)
    err = _fn("svt_probe_copy_bulk")(
        cuda_build.ptr(x), cuda_build.ptr(y), ctypes.c_longlong(x.numel() * x.element_size()),
        slot_bytes, slots, grid, cuda_build.stream_ptr(x.device))
    cuda_build.check(err, "copy_bulk")
    copy_bulk.launches += 1
    return y


copy_bulk.launches = 0


@functools.lru_cache(maxsize=None)
def _side_streams(device_index: int, priorities: tuple[int, int]):
    return tuple(torch.cuda.Stream(device_index, priority=p) for p in priorities)


def _on_two_streams(device: torch.device, priorities: tuple[int, int], first, second):
    """Run ``first()`` and ``second()`` on two side streams of the given
    priorities, both after and before the current stream's work."""
    cur = torch.cuda.current_stream(device)
    streams = _side_streams(device.index or 0, priorities)
    outs = []
    for stream, fn in zip(streams, (first, second)):
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            outs.append(fn())
    for stream in streams:
        cur.wait_stream(stream)
    return outs


def copy_bulk_split(x: torch.Tensor, slots: int, slot_rows: int, repeats: int = 1) -> torch.Tensor:
    """:func:`copy_bulk` of the first half of the rows on a high-priority
    stream and of the second half on a low-priority one, at once, each
    ``repeats`` times between one fork and one join: the counterpart of the
    TPU's DMA priorities, which Hopper has no per-copy form of inside a
    kernel."""
    if x.device.type == "cpu":
        return copy_reference(x)
    y = torch.empty_like(x)
    half = x.shape[0] // 2

    def copies(part: slice):
        for _ in range(repeats):
            copy_bulk(x[part], slots, slot_rows, out=y[part])

    _on_two_streams(x.device, (-1, 0),  # a lower number is a higher priority
                    lambda: copies(slice(None, half)), lambda: copies(slice(half, None)))
    return y


def read_only_reference(x: torch.Tensor, tile_rows: int, ctas: int = 1) -> torch.Tensor:
    """The token [8, C] f32, which every row of ``x`` enters: row r is added
    to token row r mod 8. CTA b of ``ctas`` adds the 8-row groups of its
    ``ceil(tiles / ctas)`` consecutive tiles in order, and the CTAs' sums are
    added in order. With ``ctas=1`` it is the plain in-order sum of every
    8-row group, which is ``probe_copy_bw5.py::read_only``'s token (in f32)
    at 8-row tiles; the script's token at larger tiles reads only each
    tile's first 8 rows. Each step is one f32 addition, so the kernel agrees
    bit for bit."""
    m, c = x.shape
    if m % tile_rows or tile_rows % 8 or tile_rows < 8:
        raise ValueError(f"read_only: {m} rows are no whole tiles of {tile_rows} rows, "
                         "a multiple of 8")
    n = m // tile_rows
    per = -(-n // ctas)
    groups = torch.zeros(ctas * per * tile_rows // 8, 8, c, dtype=torch.float32, device=x.device)
    groups[:m // 8] = x.view(m // 8, 8, c).float()
    groups = groups.view(ctas, per * tile_rows // 8, 8, c)
    part = torch.zeros(ctas, 8, c, dtype=torch.float32, device=x.device)
    for j in range(groups.shape[1]):
        part += groups[:, j]
    token = torch.zeros(8, c, dtype=torch.float32, device=x.device)
    for b in range(ctas):
        token += part[b]
    return token


def read_only_ctas(x: torch.Tensor, tile_rows: int, slots: int) -> int:
    """The CTAs :func:`read_only` runs on ``x``'s device (1 on the CPU)."""
    if x.device.type == "cpu":
        return 1
    return _grid("read_only", THREADS, 128 + slots * tile_rows * _row_bytes(x), x.device.index or 0)


def read_only(x: torch.Tensor, tile_rows: int, slots: int, ctas: int | None = None) -> torch.Tensor:
    """Stream ``x`` [M, C] bf16 into shared memory by ``cp.async.bulk`` (
    ``slots`` slots of one ``tile_rows``-row tile each) and write nothing back
    but the token of :func:`read_only_reference`, which every byte read
    enters (``csrc/probe_copy.cu::read_only``, then ``token_sum``), over
    ``ctas`` CTAs (a persistent grid by default)."""
    if ctas is None:
        ctas = read_only_ctas(x, tile_rows, slots)
    if x.device.type == "cpu":
        return read_only_reference(x, tile_rows, ctas)
    _check("read_only", x)
    m, c = x.shape
    if (x.dtype != torch.bfloat16 or c not in READ_ONLY_WIDTHS or m % tile_rows or tile_rows % 8
            or not 2 <= slots <= 16):
        raise ValueError(f"read_only takes bf16 [M, C] (C in {READ_ONLY_WIDTHS}) of whole "
                         "tiles of 8k rows and 2-16 slots")
    ntiles = m // tile_rows
    part = torch.empty(ctas, 8, c, dtype=torch.float32, device=x.device)
    token = torch.empty(8, c, dtype=torch.float32, device=x.device)
    err = _fn("svt_probe_read_only")(
        cuda_build.ptr(x), cuda_build.ptr(part), cuda_build.ptr(token), ctypes.c_longlong(m), c,
        tile_rows, ctypes.c_longlong(-(-ntiles // ctas)), slots, ctas,
        cuda_build.stream_ptr(x.device))
    cuda_build.check(err, "read_only")
    read_only.launches += 1
    return token


read_only.launches = 0


def write_only_reference(seed: torch.Tensor, m: int) -> torch.Tensor:
    return seed[:1].expand(m, seed.shape[1]).clone()


def write_only(seed: torch.Tensor, m: int, bulk: bool) -> torch.Tensor:
    """[m, C] rows each equal to ``seed``'s first row, written by plain
    16-byte stores or, with ``bulk``, by ``cp.async.bulk`` stores of a shared
    slot of ``WRITE_SLOT_ROWS`` such rows (``csrc/probe_copy.cu::
    write_stores``, ``write_bulk``); nothing is read but the seed."""
    if seed.device.type == "cpu":
        return write_only_reference(seed, m)
    _check("write_only", seed)
    c = seed.shape[1]
    row = c * seed.element_size()
    if row % 16:
        raise ValueError("write_only: rows must be whole 16-byte vectors")
    y = torch.empty(m, c, dtype=seed.dtype, device=seed.device)
    dev = seed.device.index or 0
    if bulk:
        grid = _grid("write_only", THREADS, WRITE_SLOT_ROWS * row, dev)
    else:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = min(-(-m * row // 16 // THREADS), 8 * sms)
    err = _fn("svt_probe_write_only")(
        cuda_build.ptr(seed), cuda_build.ptr(y), ctypes.c_longlong(m * row), row // 16, int(bulk),
        WRITE_SLOT_ROWS * row, grid, cuda_build.stream_ptr(seed.device))
    cuda_build.check(err, "write_only")
    write_only.launches += 1
    return y


write_only.launches = 0


def inc_reference(x: torch.Tensor) -> torch.Tensor:
    return x + 1


def inc_copy(a: torch.Tensor, b: torch.Tensor | None = None,
             dep: torch.Tensor | None = None) -> tuple:
    """``a + 1`` (and ``b + 1``) in bf16 in one launch of
    ``csrc/probe_copy.cu::inc_copy``; with ``dep``, each value also adds
    ``0 * dep.flatten()[0]``, a data dependence on an earlier output."""
    if a.device.type == "cpu":
        return inc_reference(a), None if b is None else inc_reference(b)
    others = [t for t in (b, dep) if t is not None]
    _check("inc_copy", a, *others)
    if a.dtype != torch.bfloat16 or (b is not None and (b.shape != a.shape or b.dtype != a.dtype)):
        raise ValueError("inc_copy takes bf16 payloads of one shape")
    ya = torch.empty_like(a)
    yb = None if b is None else torch.empty_like(b)
    none = ctypes.c_void_p(None)
    p = cuda_build.ptr
    err = _fn("svt_probe_inc_copy")(
        p(a), p(ya), none if b is None else p(b), none if b is None else p(yb),
        ctypes.c_longlong(a.numel()), none if dep is None else p(dep),
        cuda_build.stream_ptr(a.device))
    cuda_build.check(err, "inc_copy")
    inc_copy.launches += 1
    return ya, yb


inc_copy.launches = 0


def inc_two_streams(a: torch.Tensor, b: torch.Tensor, repeats: int = 1) -> tuple:
    """:func:`inc_copy` of each payload on its own stream, at once, each
    ``repeats`` times between one fork and one join."""
    if a.device.type == "cpu":
        return inc_reference(a), inc_reference(b)

    def incs(x):
        return [inc_copy(x)[0] for _ in range(repeats)][-1]

    return tuple(_on_two_streams(a.device, (0, 0), lambda: incs(a), lambda: incs(b)))


def inc_interleaved(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Two :func:`inc_copy` launches on one stream, the second depending on
    the first's output."""
    ya = inc_copy(a)[0]
    return ya, inc_copy(b, dep=ya)[0]


# ---------------------------------------------------------------- the probes


def _copy_row(probe, variant, kernel, config, x, call, out, cold=False) -> Row:
    """A copy of ``x``; ``out`` (``x``'s shape) takes the yardstick's copy."""
    return Row(probe, variant, kernel, config, nbytes=2 * x.numel() * x.element_size(), flops=0,
               f32_ops=0, rate="GB/s", call=call, plain=lambda: copy_reference(x),
               library=lambda: out.copy_(x), tol=None, cold=cold)


def _inc_row(probe, variant, x) -> Row:
    y = x.clone()
    return Row(probe, variant, "torch", "x.add_(1)", 2 * x.numel() * x.element_size(), 0,
               x.numel(), "GB/s", call=lambda: y.add_(1), plain=None, library=None,
               tol=None)


def stages(device, batch: int, rng) -> list[Row]:
    """``probe_copy_bw.py``: a copy of each ConvNeXt-base stage's [B*H*W, C]
    bf16 activations at 512^2, a CTA per tile of rows, 16 bytes a thread, the
    L2 cache flushed before each launch (the 16^2 x 1024 stage, 16.8 MB at
    B = 32, would otherwise stay in its 50 MB)."""
    rows = []
    for hw, c in STAGES:
        m = batch * hw * hw
        x = normal(rng, (m, c), 1.0, torch.bfloat16, device)
        out = torch.empty_like(x)
        name = f"{hw}x{hw}x{c}"
        for tile in TILES:
            if m % tile:
                continue
            rows.append(_copy_row("probe_copy_bw", f"{name} t{tile}", "copy_tiled",
                                  f"{tile} rows a CTA, 16 B", x,
                                  lambda x=x, t=tile: copy_tiled(x, t), out, cold=True))
        inc = _inc_row("probe_copy_bw", f"{name} xla_add", x)
        inc.cold = True
        rows.append(inc)
    return rows


def mechanisms(device, batch: int, rng) -> list[Row]:
    """``probe_copy_bw2.py`` on stage 1's [B*128*128, 128] bf16 (134 MB at
    B = 32): tiled copies, the wide view, the cp.async ring and the bulk copy.
    The TPU's tile_m of the ring and of the DMA has no counterpart; a slot
    holds what shared memory does."""
    m = batch * IMAGE_TOKENS
    x = normal(rng, (m, 128), 1.0, torch.bfloat16, device)
    rows = [_inc_row("probe_copy_bw2", "xla_inc", x)]
    out = torch.empty_like(x)
    rows.append(Row("probe_copy_bw2", "copy_engine", "torch", "dst.copy_(src)", 2 * x.numel() * 2,
                    0, 0, "GB/s", call=lambda: out.copy_(x), plain=None, library=None,
                    tol=None))
    for tile in (1024, 4096, 16384):
        if m % tile == 0:
            rows.append(_copy_row("probe_copy_bw2", f"auto_t{tile}", "copy_tiled",
                                  f"{tile} rows a CTA, 16 B", x,
                                  lambda t=tile: copy_tiled(x, t), out))
    if m % 8 == 0 and (m // 8) % 4096 == 0:
        wide = x.view(m // 8, 8 * 128)
        rows.append(_copy_row("probe_copy_bw2", "wide_t4096", "copy_tiled",
                              "[M/8, 8C] view, 4096 rows a CTA, 16 B", wide,
                              lambda: copy_tiled(wide, 4096), out.view_as(wide)))
    for slots in (2, 3, 4):
        rows.append(_copy_row("probe_copy_bw2", f"manual_t4096_k{slots}", "copy_staged",
                              f"S={slots}, 64-row (16 KB) slots", x,
                              lambda s=slots: copy_staged(x, s, 64), out))
    rows.append(_copy_row("probe_copy_bw2", "manual_t16384_k2", "copy_staged",
                          "S=2, 256-row (64 KB) slots", x, lambda: copy_staged(x, 2, 256), out))
    rows.append(_copy_row("probe_copy_bw2", "hbm_dma", "copy_bulk", "S=2, 384-row (96 KB) slots",
                          x, lambda: copy_bulk(x, 2, 384), out))
    return rows


def dtypes(device, batch: int, rng) -> list[Row]:
    """``probe_copy_bw3.py``: the same 134 MB (at B = 32) as bf16 at C = 128,
    256, 512, 1024, f32 at C = 128, 512 and int8 at C = 256, 1024 rows a CTA,
    each per element and 16 bytes a thread."""
    nbytes = batch * IMAGE_TOKENS * 128 * 2
    x16 = normal(rng, (nbytes // 2,), 1.0, torch.bfloat16, device)
    x32 = normal(rng, (nbytes // 4,), 1.0, torch.float32, device)
    x8 = torch.from_numpy(rng.integers(0, 127, size=nbytes, dtype=np.int8)).to(device)
    outs = {t.dtype: torch.empty_like(t) for t in (x16, x32, x8)}
    rows = [_inc_row("probe_copy_bw3", "xla_inc_bf16", x16)]
    views = [(f"bf16_c{c}", x16.view(-1, c)) for c in (128, 256, 512, 1024)]
    views += [(f"f32_c{c}", x32.view(-1, c)) for c in (128, 512)]
    views.append(("int8_c256", x8.view(-1, 256)))
    for name, v in views:
        if v.shape[0] % 1024:
            continue
        for vector, access in ((False, f"{v.element_size()} B"), (True, "16 B")):
            rows.append(_copy_row("probe_copy_bw3", f"{name} {access}", "copy_tiled",
                                  f"1024 rows a CTA, {access} a thread", v,
                                  lambda v=v, vec=vector: copy_tiled(v, 1024, vec),
                                  outs[v.dtype].view_as(v)))
    return rows


def in_flight(device, batch: int, rng) -> list[Row]:
    """``probe_copy_bw4.py``: many copies in flight. The cp.async ring with S
    slots of 16 KB up to what 227 KB of shared memory holds (S = 12), and the
    bulk copy with S slots in flight a CTA (S = 4, 8, 16 slots sharing 128 KB,
    and S = 8 of 24 KB)."""
    x = normal(rng, (batch * IMAGE_TOKENS, 128), 1.0, torch.bfloat16, device)
    out = torch.empty_like(x)
    rows = [_inc_row("probe_copy_bw4", "xla_inc", x)]
    for slots in (2, 4, 8, 12):
        rows.append(_copy_row("probe_copy_bw4", f"vmem_s{slots}_t2048", "copy_staged",
                              f"S={slots}, 64-row (16 KB) slots", x,
                              lambda s=slots: copy_staged(x, s, 64), out))
    for slots, slot_rows in ((4, 128), (8, 64), (16, 32)):
        rows.append(_copy_row("probe_copy_bw4", f"hbm_s{slots}_t2048", "copy_bulk",
                              f"S={slots}, {slot_rows}-row ({slot_rows // 4} KB) slots", x,
                              lambda s=slots, r=slot_rows: copy_bulk(x, s, r), out))
    rows.append(_copy_row("probe_copy_bw4", "hbm_s8_t8192", "copy_bulk",
                          "S=8, 96-row (24 KB) slots", x, lambda: copy_bulk(x, 8, 96), out))
    return rows


def directions(device, batch: int, rng) -> list[Row]:
    """``probe_copy_bw5.py``: one direction at a time (rates count the bytes
    of that direction only), the DMA priorities' counterpart and the double
    buffering of ``emit_pipeline``."""
    m = batch * IMAGE_TOKENS
    x = normal(rng, (m, 128), 1.0, torch.bfloat16, device)
    seed = normal(rng, (8, 128), 1.0, torch.bfloat16, device)
    size = x.numel() * 2
    rows = [_inc_row("probe_copy_bw5", "xla_inc", x)]
    for variant, slots, tile in (("read_only_s8", 8, 32), ("read_only_s4_t128", 4, 128)):
        ctas = read_only_ctas(x, tile, slots)
        rows.append(Row(
            "probe_copy_bw5", variant, "read_only",
            f"S={slots}, {tile}-row ({tile // 4} KB) slots, {ctas} CTAs", size, 0, x.numel(),
            "GB/s", call=lambda s=slots, t=tile, k=ctas: read_only(x, t, s, k),
            plain=lambda t=tile, k=ctas: read_only_reference(x, t, k),
            library=lambda: torch.sum(x.view(m // 8, 8, 128), 0, dtype=torch.float32),
            tol=None))
    out = torch.empty_like(x)
    for bulk, variant, config in ((True, "write_only_s8", "cp.async.bulk of a 32 KB slot"),
                                  (False, "write_only_stores", "16-byte stores")):
        rows.append(Row("probe_copy_bw5", variant, "write_only", config, size, 0, 0, "GB/s",
                        call=lambda b=bulk: write_only(seed, m, b),
                        plain=lambda: write_only_reference(seed, m),
                        library=lambda: out.copy_(seed[:1].expand(m, 128)), tol=None))
    for variant, slots in (("prio_split_s8", 8), ("vmem_prio_s4", 4), ("vmem_prio_s8", 8)):
        row = _copy_row("probe_copy_bw5", variant, "copy_bulk",
                        f"two halves on high/low-priority streams, S={slots}, "
                        f"{512 // slots}-row slots, {REPEATS} copies a fork", x,
                        lambda s=slots: copy_bulk_split(x, s, 512 // s, REPEATS), out)
        row.calls = REPEATS
        rows.append(row)
    rows.append(_copy_row("probe_copy_bw5", "emitpipe_t2048", "copy_staged",
                          "S=2, 64-row (16 KB) slots", x, lambda: copy_staged(x, 2, 64), out))
    return rows


def two_kernels(device, batch: int, rng) -> list[Row]:
    """``probe_copy_bw6.py``: ``x + 1`` over two payloads of [B/2*128*128,
    128] bf16 (67 MB each at B = 32) in one launch, two launches on two
    streams, and two launches on one stream with a data dependence."""
    m = max(1, batch // 2) * IMAGE_TOKENS
    a = normal(rng, (m, 128), 1.0, torch.bfloat16, device)
    b = normal(rng, (m, 128), 1.0, torch.bfloat16, device)
    total = 2 * 2 * a.numel() * 2
    ya, yb = torch.empty_like(a), torch.empty_like(b)

    def library():
        torch.add(a, 1, out=ya)
        torch.add(b, 1, out=yb)

    def plain():
        return inc_reference(a), inc_reference(b)

    def repeated(fn):
        return lambda: [fn() for _ in range(REPEATS)][-1]

    rows = []
    for variant, config, call in (
            ("one_kernel", "one launch over both", repeated(lambda: inc_copy(a, b))),
            ("two_kernels", "a launch a payload, two streams",
             lambda: inc_two_streams(a, b, REPEATS)),
            ("interleaved", "two launches, one stream, data dependence",
             repeated(lambda: inc_interleaved(a, b)))):
        rows.append(Row("probe_copy_bw6", variant, "inc_copy", f"{config}, {REPEATS} a call",
                        total, 0, 2 * a.numel(), "GB/s", call=call, plain=plain,
                        library=library, tol=None, calls=REPEATS))
    aa, bb = a.clone(), b.clone()

    def xla_two():
        aa.add_(1)
        bb.add_(1)

    rows.append(Row("probe_copy_bw6", "xla_two", "torch", "a.add_(1); b.add_(1)", total, 0,
                    2 * a.numel(), "GB/s", call=xla_two, plain=None, library=None,
                    tol=None))
    return rows


TABLES = (stages, mechanisms, dtypes, in_flight, directions, two_kernels)


def run(device: str | torch.device = "cuda", batch: int = 32, report=print) -> list[Row]:
    """Every streaming probe at batch ``batch`` (the scripts' 32): each row
    timed on the card (nothing timed on the CPU), reported as it completes."""
    from spine_vision_torch.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(SEED)
    rows = []
    for table in TABLES:
        for row in table(dev, batch, rng):
            rows.append(measure(row, dev))
            report(format_row(row))
    return rows

