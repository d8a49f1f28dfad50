"""The requirement screen: verdict[n, b] = Requirements.Compatible(slot row
n as the node side, item row b as the pod side), requirements.go:123-133.

Replaces the Pallas TPU kernel of karpenter_core_tpu/ops/pallas_kernels.py
(``_screen_kernel`` in its two grid forms, ``slot_screen_pallas`` and
``batched_slot_screen_pallas``) with two kernels written by hand for
Hopper, both in ``csrc/screen.cu``:

* ``screen_prep`` re-lays a side's bool planes once per row: the value
  plane in the ``ScreenLayout`` word order (every key segment starts on a
  32-value word), as packed words for the row forms and as int8 bytes for
  the block form, and per-row key bitmasks (def, out, esc, deny) of
  ``ceil(K / 32)`` words. The slot side's escape flags are derived here,
  once per row. Its plain version is ``screen_prep_plain``.
* ``screen`` computes the verdicts from two prepared sides: the block form
  (N > 1 and B > 1) as a segmented int8 contraction on the tensor cores,
  the row forms (N = 1 or B = 1) on the SIMT cores. Its plain version is
  ``screen_plain``.

The item side is prepared once, when its ``ScreenItems`` is made; every
screen call then issues at most two launches (prep of the slot side, then
the screen). See the source for the kernels' design.

Semantics match the reference's screen ops exactly:

* the value axis may be cut to a screen width w (the encoder-proven
  hostname tail); key k reads its segment clipped to [0, w);
* ``every_key=False`` skips keys whose segment starts at or past w, as
  ``make_screen_ops.rows_vs_items`` does; ``every_key=True`` evaluates
  every key on its clipped (possibly empty) segment, as the Pallas kernel
  and ``items_vs_row`` do. The two agree whenever no item defines an
  elided key, which the encoder guarantees;
* the custom-key deny reads all K keys.

The wrappers use the plain versions only for tensors on the CPU (the
tests); a CUDA tensor launches the kernels or raises. Each launch runs on
its tensors' card, under that card's device guard and stream, whatever
card the calling thread has current (a tile of the device grid,
parallel/specs.py, may sit on any card of the process).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_core_tpu_torch.ops.compat import _count
from karpenter_core_tpu_torch.ops.cuda_build import KernelError

# launches of each CUDA kernel, counted where it is launched
LAUNCHES: Dict[str, int] = {"screen": 0, "screen_prep": 0}
# launches of the screen kernel by form: block (N > 1, B > 1), row_n1 (one
# slot row against every item row), row_b1 (every slot row against one item)
FORM_LAUNCHES: Dict[str, int] = {"block": 0, "row_n1": 0, "row_b1": 0}
# launches of either kernel by the device they ran on ("cuda:1")
DEVICE_LAUNCHES: Dict[str, int] = {}

ITEM_KEYS = ("allow", "out", "defined", "escape", "custom_deny")
_FORM_CODE = {"block": 0, "row_n1": 1, "row_b1": 2}
# The kernels stage the word->key map (and the row forms the single row's
# words) in shared memory: 4096 words (131,072 values) keep the row forms
# under the default 48 KB, and with 512 keys the block form's word keys
# and key bitmasks fit beside its 144 KB of tiles within a block's 227 KB.
MAX_WORDS = 4096
MAX_KEYS = 512


def reset_launches() -> None:
    for counts in (LAUNCHES, FORM_LAUNCHES):
        for k in counts:
            counts[k] = 0
    DEVICE_LAUNCHES.clear()


def _counted(kernel: str, dev: torch.device, form: Optional[str] = None) -> None:
    LAUNCHES[kernel] += 1
    if form is not None:
        FORM_LAUNCHES[form] += 1
    DEVICE_LAUNCHES[str(dev)] = DEVICE_LAUNCHES.get(str(dev), 0) + 1


def launch_counts() -> Dict[str, int]:
    """A copy of the launch counts, by kernel and by form of the screen."""
    return {**LAUNCHES, **FORM_LAUNCHES}


def device_launch_counts() -> Dict[str, int]:
    """A copy of the launch counts of both kernels, by device."""
    return dict(DEVICE_LAUNCHES)


def _clip(segments, width: int, every_key: bool):
    """Per key: (on, lo, hi) with the segment clipped to the screen width."""
    return [
        (every_key or lo < width, min(lo, width), min(hi, width))
        for lo, hi in segments
    ]


def screen_plain(s_allow, s_out, s_defined, items, segments, every_key=False):
    """[N, B] verdicts in plain PyTorch (the rows_vs_items math,
    pack.py:119-163). s_allow [N, w] is already cut to the screen width;
    items: allow [B, w], out/defined/escape/custom_deny [B, K]."""
    width = s_allow.shape[1]
    N, B = s_allow.shape[0], items["allow"].shape[0]
    keys = _clip(segments, width, every_key)
    ok = torch.ones((N, B), dtype=torch.bool, device=s_allow.device)
    for k, (on, lo, hi) in enumerate(keys):
        if not on:
            continue  # elided tail key: resolves through ~shared
        if hi > lo:
            seg = s_allow[:, lo:hi]
            has_allow = seg.any(dim=-1)
            has_excl = (~seg).any(dim=-1)
            inter = _count(seg, items["allow"][:, lo:hi].T) > 0.5
        else:
            has_allow = torch.zeros(N, dtype=torch.bool, device=s_allow.device)
            has_excl = has_allow
            inter = None
        s_esc = s_defined[:, k] & (
            (s_out[:, k] & has_excl) | (~s_out[:, k] & ~has_allow)
        )
        shared = s_defined[:, k: k + 1] & items["defined"][None, :, k]
        nonempty = s_out[:, k: k + 1] & items["out"][None, :, k]
        if inter is not None:
            nonempty = nonempty | inter
        escapes = s_esc[:, None] & items["escape"][None, :, k]
        ok &= (~shared) | nonempty | escapes
    denied = _count(~s_defined, items["custom_deny"].T) > 0.5
    return ok & ~denied


class ScreenLayout:
    """The packed value-axis layout for one (segments, screen width, key
    rule): each key's clipped segment takes whole 32-bit words, so a word
    is one k32 slab of the block form's contraction. The key rule changes
    only which keys take part (``on_mask``), never the packing."""

    def __init__(self, segments: Sequence[Tuple[int, int]], width: int,
                 every_key: bool = False):
        self.segments = [tuple(s) for s in segments]
        self.width = int(width)
        self.every_key = bool(every_key)
        self.K = len(self.segments)
        if self.K > MAX_KEYS:
            raise ValueError(f"screen: {self.K} keys exceed {MAX_KEYS}")
        self.KW = max(1, (self.K + 31) // 32)
        keys = _clip(self.segments, self.width, self.every_key)
        on, src, word_key = [], [], []
        for k, (k_on, lo, hi) in enumerate(keys):
            # a key cut to an empty segment takes no words in either rule
            if lo < hi:
                nbits = (hi - lo + 31) // 32 * 32
                src.extend(range(lo, hi))
                src.extend([-1] * (nbits - (hi - lo)))
                word_key.extend([k] * (nbits // 32))
            on.append(k_on)
        self.n_words = len(src) // 32
        if self.n_words > MAX_WORDS:
            raise ValueError(f"screen: {self.n_words} packed words exceed {MAX_WORDS}")
        # the value column each bit reads, -1 past a segment's end
        self.bit_col = np.asarray(src, dtype=np.int32)
        self.word_key = np.asarray(word_key, dtype=np.int32)
        on_bits = np.zeros(32 * self.KW, dtype=bool)
        on_bits[: self.K] = on
        self.on_mask = _pack_bits_np(on_bits[None])[:, 0]
        # the packing: layouts that share it share prepared item planes
        self.pack_key = (tuple(self.segments), self.width)
        self._dev = {}

    def device_arrays(self, device):
        key = str(device)
        got = self._dev.get(key)
        if got is None:
            got = self._dev[key] = {
                name: torch.as_tensor(getattr(self, name), device=device)
                for name in ("bit_col", "word_key", "on_mask")
            }
        return got


def _pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """[R, 32 n] bool -> [n, R] int32: bit j of word w is column 32 w + j."""
    R, n = bits.shape[0], bits.shape[1] // 32
    words = (bits.reshape(R, n, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1)
    return words.astype(np.uint32).view(np.int32).T.copy()


_SHIFTS = {}


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[R, 32 n] bool -> [n, R] int32 (word-major): bit j of word w is
    column 32 w + j."""
    R, n = bits.shape[0], bits.shape[1] // 32
    shifts = _SHIFTS.get(str(bits.device))
    if shifts is None:
        shifts = _SHIFTS[str(bits.device)] = torch.arange(
            32, dtype=torch.int64, device=bits.device
        )
    words = (bits.reshape(R, n, 32).to(torch.int64) << shifts).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).T.contiguous()


def screen_prep_plain(allow, out, defined, layout: ScreenLayout,
                      escape=None, custom_deny=None) -> Dict[str, torch.Tensor]:
    """One side's planes prepared for the screen, in plain PyTorch.

    allow [R, >= width] bool (columns past the width are ignored),
    out/defined [R, K] bool; escape and custom_deny [R, K] bool on the item
    side, None on the slot side (escape is then derived from the row's own
    words: def & ((out & has_excl) | (~out & ~has_allow)), deny is 0).
    Returns words [W, R] int32 (word-major), bytes [R, 32 W] int8 (0/1, the
    same bits one per byte) and flags [4, KW, R] int32: the def, out, esc and
    deny bitmasks, bit k of word q is key 32 q + k."""
    R, K = allow.shape[0], layout.K
    dev = allow.device
    allow = allow[:, : layout.width]
    padded = torch.cat([allow, torch.zeros((R, 1), dtype=torch.bool, device=dev)], dim=1)
    col = torch.as_tensor(layout.bit_col, dtype=torch.int64, device=dev)
    bits = padded[:, torch.where(col < 0, layout.width, col)]  # [R, 32 W]
    if escape is None:
        esc = torch.zeros((R, K), dtype=torch.bool, device=dev)
        for k, (_on, lo, hi) in enumerate(_clip(layout.segments, layout.width, True)):
            if hi > lo:
                seg = allow[:, lo:hi]
                has_allow, has_excl = seg.any(dim=-1), (~seg).any(dim=-1)
            else:
                has_allow = has_excl = torch.zeros(R, dtype=torch.bool, device=dev)
            esc[:, k] = defined[:, k] & ((out[:, k] & has_excl) | (~out[:, k] & ~has_allow))
        deny = torch.zeros((R, K), dtype=torch.bool, device=dev)
    else:
        esc, deny = escape, custom_deny
    pad = torch.zeros((R, 32 * layout.KW - K), dtype=torch.bool, device=dev)
    flags = torch.stack([
        _pack_bits(torch.cat([plane, pad], dim=1)) for plane in (defined, out, esc, deny)
    ])
    return {"words": _pack_bits(bits), "bytes": bits.to(torch.int8), "flags": flags}


def _c_kernels():
    """The C entry points of csrc/screen.cu, built and loaded on first use."""
    from karpenter_core_tpu_torch.ops import cuda_build

    lib = cuda_build.load("screen")
    prep, scr = lib.screen_prep_launch, lib.screen_launch
    if prep.argtypes is None:  # pointers must not travel as 32-bit ints
        p, i = ctypes.c_void_p, ctypes.c_int
        prep.argtypes = [p, i] * 5 + [p] * 5 + [i] * 4 + [p]
        prep.restype = ctypes.c_int
        scr.argtypes = [i] + [p] * 6 + [i] * 2 + [p] * 3 + [i] * 4 + [p]
        scr.restype = ctypes.c_int
    return prep, scr


def _stream(dev: torch.device) -> int:
    """The current stream's raw handle on `dev`. (torch.cuda.current_stream()
    builds a Python object per call, which costs more host time than a
    row-form kernel takes on the card.)"""
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if dev.index is None else dev.index)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"screen: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"screen: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"screen: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"screen: {name} must be contiguous")


def _rows(t: torch.Tensor, name: str, R: int, min_cols: int, device) -> torch.Tensor:
    """A bool plane the prep kernel reads by row stride: unit column stride."""
    if t.dtype != torch.bool:
        raise TypeError(f"screen: {name} must be torch.bool, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != R or t.shape[1] < min_cols:
        raise ValueError(f"screen: {name} must have shape [{R}, >= {min_cols}], "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"screen: {name} is on {t.device}, expected {device}")
    return t if t.stride(1) == 1 or t.shape[1] <= 1 else t.contiguous()


def screen_prep(allow, out, defined, layout: ScreenLayout, escape=None,
                custom_deny=None, words: bool = True,
                planes: bool = True) -> Dict[str, Optional[torch.Tensor]]:
    """screen_prep_plain's outputs, from the prep kernel on the card (one
    launch). ``words``/``planes`` False leave that output out (None): the
    row forms read only the words, the block form only the bytes."""
    dev = allow.device
    if dev.type == "cpu":
        return screen_prep_plain(allow, out, defined, layout, escape, custom_deny)
    if dev.type != "cuda":
        raise ValueError(f"screen: unsupported device {dev}")
    R, K, W, KW = allow.shape[0], layout.K, layout.n_words, layout.KW
    item_side = escape is not None
    if item_side != (custom_deny is not None):
        raise ValueError("screen: escape and custom_deny come together (the item side)")
    allow = _rows(allow, "allow", R, layout.width, dev)
    src = [allow, _rows(out, "out", R, K, dev), _rows(defined, "defined", R, K, dev)]
    if item_side:
        src += [_rows(escape, "escape", R, K, dev), _rows(custom_deny, "custom_deny", R, K, dev)]
    got = {
        "words": torch.empty((W, R), dtype=torch.int32, device=dev) if words else None,
        "bytes": torch.empty((R, 32 * W), dtype=torch.int8, device=dev) if planes else None,
        "flags": torch.empty((4, KW, R), dtype=torch.int32, device=dev),
    }
    if R == 0:
        return got
    ptrs = []
    for t in src + [None] * (5 - len(src)):
        ptrs += [None, 0] if t is None else [t.data_ptr(), t.stride(0)]
    lay = layout.device_arrays(dev)
    prep, _ = _c_kernels()
    # the C entry launches on the calling thread's current card
    with torch.cuda.device(dev):
        rc = prep(
            *ptrs, lay["bit_col"].data_ptr(), lay["word_key"].data_ptr(),
            got["words"].data_ptr() if words else None,
            got["bytes"].data_ptr() if planes else None,
            got["flags"].data_ptr(), R, W, K, KW,
            _stream(dev),
        )
    if rc != 0:
        raise KernelError(f"screen_prep kernel launch failed: CUDA error {rc}")
    _counted("screen_prep", dev)
    return got


class ScreenItems:
    """The item (pod) side of a screen in one layout's packing, prepared
    once, here, and reused by every launch against it: the bool planes and,
    on the card, their words, bytes and key bitmasks (one prep launch).
    Layouts that share the packing (both key rules) share it."""

    def __init__(self, planes: Dict[str, torch.Tensor], layout: ScreenLayout):
        p = self.planes = {k: planes[k] for k in ITEM_KEYS}
        self.B = int(p["allow"].shape[0])
        self.device = p["allow"].device
        self.pack_key = layout.pack_key
        self.prepared = None
        if self.device.type == "cuda":
            self.prepared = screen_prep(p["allow"], p["out"], p["defined"], layout,
                                        escape=p["escape"], custom_deny=p["custom_deny"])

    def take(self, idx: torch.Tensor) -> "ScreenItems":
        """Item rows `idx`, gathered from these planes and prepared arrays
        (no second prep launch)."""
        out = ScreenItems.__new__(ScreenItems)
        out.planes = {k: v[idx] for k, v in self.planes.items()}
        out.B, out.device, out.pack_key = int(idx.shape[0]), self.device, self.pack_key
        out.prepared = None
        if self.prepared is not None:
            p = self.prepared
            out.prepared = {
                "words": None if p["words"] is None else p["words"][:, idx].contiguous(),
                "bytes": None if p["bytes"] is None else p["bytes"][idx].contiguous(),
                "flags": p["flags"][:, :, idx].contiguous(),
            }
        return out

    def check_packing(self, layout: ScreenLayout) -> None:
        if layout.pack_key != self.pack_key:
            raise ValueError("screen: the items were prepared in another layout's packing")


def _launch(form: str, slot: Dict[str, torch.Tensor], items: ScreenItems, b: int,
            layout: ScreenLayout, N: int) -> torch.Tensor:
    """One launch of the screen kernel on prepared sides: [N, B] verdicts
    for the block and row_n1 forms, [N] for row_b1 (item row b)."""
    dev = items.device
    W, KW, B = layout.n_words, layout.KW, items.B
    it = items.prepared
    _check(slot["flags"], "slot flags", torch.int32, (4, KW, N), dev)
    _check(it["flags"], "item flags", torch.int32, (4, KW, B), dev)
    if form == "block":
        _check(slot["bytes"], "slot bytes", torch.int8, (N, 32 * W), dev)
        _check(it["bytes"], "item bytes", torch.int8, (B, 32 * W), dev)
        verdict = torch.empty((N, B), dtype=torch.bool, device=dev)
    else:
        _check(slot["words"], "slot words", torch.int32, (W, N), dev)
        _check(it["words"], "item words", torch.int32, (W, B), dev)
        if form == "row_n1":
            verdict = torch.empty((1, B), dtype=torch.bool, device=dev)
        else:
            if not 0 <= b < B:
                raise IndexError(f"screen: item row {b} out of range [0, {B})")
            verdict = torch.empty((N,), dtype=torch.bool, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lay = layout.device_arrays(dev)
    _, scr = _c_kernels()
    with torch.cuda.device(dev):
        rc = scr(
            _FORM_CODE[form], ptr(slot["words"]), ptr(slot["bytes"]), slot["flags"].data_ptr(),
            ptr(it["words"]), ptr(it["bytes"]), it["flags"].data_ptr(), B, b,
            lay["on_mask"].data_ptr(), lay["word_key"].data_ptr(), verdict.data_ptr(),
            N, 1 if form == "row_b1" else B, W, KW, _stream(dev),
        )
    if rc != 0:
        raise KernelError(f"screen kernel launch failed: CUDA error {rc}")
    _counted("screen", dev, form)
    return verdict


def _cpu_items(items: ScreenItems, layout: ScreenLayout, rows=slice(None)):
    p = items.planes
    return {k: (v[rows, : layout.width] if k == "allow" else v[rows]) for k, v in p.items()}


def form_of(N: int, B: int) -> str:
    """The screen kernel's form for N slot rows against B item rows."""
    return "row_n1" if N == 1 else "row_b1" if B == 1 else "block"


def screen_block(s_allow, s_out, s_defined, items: ScreenItems,
                 layout: ScreenLayout) -> torch.Tensor:
    """[N, B] slot-major verdicts of N slot rows against every item row.
    s_allow [N, >= width] (columns past the layout's width are ignored),
    s_out/s_defined [N, K] bool. The form follows the shape (form_of)."""
    dev = s_allow.device
    items.check_packing(layout)
    if dev.type == "cpu":
        return screen_plain(s_allow[:, : layout.width], s_out, s_defined,
                            _cpu_items(items, layout), layout.segments, layout.every_key)
    if dev.type != "cuda":
        raise ValueError(f"screen: unsupported device {dev}")
    N, B = s_allow.shape[0], items.B
    if N == 0 or B == 0:
        return torch.zeros((N, B), dtype=torch.bool, device=dev)
    form = form_of(N, B)
    if form == "row_b1":
        return screen_row(s_allow, s_out, s_defined, items, 0, layout)[:, None]
    slot = screen_prep(s_allow, s_out, s_defined, layout,
                       words=form == "row_n1", planes=form == "block")
    return _launch(form, slot, items, 0, layout, N)


def screen_row(s_allow, s_out, s_defined, items: ScreenItems, b: int,
               layout: ScreenLayout) -> torch.Tensor:
    """[N] verdicts of N slot rows against item row b of ``items``: the
    B = 1 form (the reference's slot_screen_pallas). The item row comes
    from the prepared item side."""
    dev = s_allow.device
    items.check_packing(layout)
    if dev.type == "cpu":
        return screen_plain(s_allow[:, : layout.width], s_out, s_defined,
                            _cpu_items(items, layout, slice(b, b + 1)),
                            layout.segments, layout.every_key)[:, 0]
    if dev.type != "cuda":
        raise ValueError(f"screen: unsupported device {dev}")
    N = s_allow.shape[0]
    if N == 0:
        return torch.zeros((0,), dtype=torch.bool, device=dev)
    slot = screen_prep(s_allow, s_out, s_defined, layout, planes=False)
    return _launch("row_b1", slot, items, b, layout, N)
