"""The requirement screen of the port (ops/screen.py) against the
reference's Pallas kernel in interpret mode, in both grid forms, and
against the reference's matmul screen with a cut value axis.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
On the CPU, `screen_prep_plain` is held against the reference's escape
flags and planes, and `_emulate_block` / `_emulate_row` replay the
kernels' algorithms (csrc/screen.cu) in numpy over its outputs, which
checks the layout, the key bitmasks and the per-key accumulation."""
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from karpenter_core_tpu.ops import compat as jcompat
from karpenter_core_tpu.ops.pack import make_screen_ops
from karpenter_core_tpu.ops.pallas_kernels import (
    batched_slot_screen_pallas,
    slot_screen_pallas,
)

from karpenter_core_tpu_torch.ops import screen
from karpenter_core_tpu_torch.ops.screen import (
    ScreenItems,
    ScreenLayout,
    screen_block,
    screen_plain,
    screen_prep_plain,
    screen_row,
)

SMALL = [(0, 3), (3, 3), (3, 10), (10, 40), (40, 41)]  # incl. an empty segment


def _large_segments():
    rng = np.random.default_rng(7)
    bounds = np.cumsum([0] + list(rng.integers(1, 40, size=12)))
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def _bounds(lengths):
    b = np.cumsum([0] + list(lengths))
    return [(int(x), int(y)) for x, y in zip(b[:-1], b[1:])]


# empty segments and a 1,300-value key (41 words)
WIDE = _bounds([3, 0, 7, 30, 1, 1300, 2, 0, 90])
# K = 40 keys: the key bitmasks take two words
MANY = _bounds(np.random.default_rng(4).integers(0, 6, size=40))


def random_case(rng, n_slots, n_items, segments):
    """The layout of tests/test_pallas_kernels.py's random_case, with a
    batch of item rows."""
    V = segments[-1][1]
    K = len(segments)
    slot = {
        "allow": rng.random((n_slots, V)) < 0.7,
        "out": rng.random((n_slots, K)) < 0.3,
        "defined": rng.random((n_slots, K)) < 0.6,
    }
    items = {
        "allow": rng.random((n_items, V)) < 0.6,
        "out": rng.random((n_items, K)) < 0.3,
        "defined": rng.random((n_items, K)) < 0.7,
        "escape": rng.random((n_items, K)) < 0.2,
        "custom_deny": rng.random((n_items, K)) < 0.2,
    }
    return slot, items


def structured_case(rng, n_slots, n_items, segments):
    """random_case with whole key segments set full or empty on a third of
    the (row, key) cells each, and sparse item rows, so that wide keys
    reach every branch: no intersection, no allowed value, no excluded
    value."""
    slot, items = random_case(rng, n_slots, n_items, segments)
    items["allow"] = rng.random(items["allow"].shape) < 0.05
    for plane in (slot["allow"], items["allow"]):
        for k, (lo, hi) in enumerate(segments):
            pick = rng.random(plane.shape[0])
            plane[pick < 0.33, lo:hi] = False
            plane[pick > 0.67, lo:hi] = True
    return slot, items


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


CASES = [("small", SMALL, 37, 5, 0), ("small", SMALL, 300, 3, 1),
         ("large", None, 300, 9, 2)]


@pytest.mark.parametrize("name,segments,n_slots,n_items,seed", CASES)
def test_screen_row_matches_pallas_row_form(name, segments, n_slots, n_items, seed):
    segments = segments or _large_segments()
    rng = np.random.default_rng(seed)
    slot, items = random_case(rng, n_slots, n_items, segments)
    V = segments[-1][1]
    layout = ScreenLayout(segments, V, every_key=True)
    sm = jcompat.seg_matrix(segments, V)
    ts, ti = _t(slot), ScreenItems(_t(items), layout)
    for b in range(n_items):
        row = {k: v[b] for k, v in items.items()}
        want = slot_screen_pallas(
            jnp.asarray(slot["allow"]), jnp.asarray(slot["out"]),
            jnp.asarray(slot["defined"]), {k: jnp.asarray(v) for k, v in row.items()},
            sm, interpret=True,
        )
        got = screen_row(ts["allow"], ts["out"], ts["defined"], ti, b, layout)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("width_cut", [0, 37, 95])
def test_screen_row_matches_pallas_at_the_tiered_shape(width_cut):
    """The tiered screen's shape: several thousand open slot rows (a ragged
    count) against one item row, on the value axis cut to the screen width
    with every key evaluated, as the reference's tiered screen calls
    slot_screen_pallas on allow[:, :screen_v] with the cut segment
    matrix (a cut of 95 leaves the last key wholly past the width)."""
    segments = WIDE
    rng = np.random.default_rng(30 + width_cut)
    slot, items = structured_case(rng, 3001, 2, segments)
    V = segments[-1][1]
    w = V - width_cut
    layout = ScreenLayout(segments, w, every_key=True)
    sm = jcompat.seg_matrix(segments, V)[:w]
    ts, ti = _t(slot), ScreenItems(_t(items), layout)
    for b in range(2):
        want = slot_screen_pallas(
            jnp.asarray(slot["allow"][:, :w]), jnp.asarray(slot["out"]),
            jnp.asarray(slot["defined"]),
            {k: jnp.asarray(v[b, :w] if k == "allow" else v[b]) for k, v in items.items()},
            sm, interpret=True,
        )
        got = screen_row(ts["allow"], ts["out"], ts["defined"], ti, b, layout)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if width_cut < 90:  # past it, the random rows mostly fail the last key
            assert np.asarray(want).any() and not np.asarray(want).all()


@pytest.mark.parametrize("name,segments,n_slots,n_items,seed", CASES)
def test_screen_block_matches_pallas_batched_form(name, segments, n_slots, n_items,
                                                  seed):
    segments = segments or _large_segments()
    rng = np.random.default_rng(seed + 10)
    slot, items = random_case(rng, n_slots, n_items, segments)
    V = segments[-1][1]
    want = batched_slot_screen_pallas(
        jnp.asarray(slot["allow"]), jnp.asarray(slot["out"]),
        jnp.asarray(slot["defined"]), {k: jnp.asarray(v) for k, v in items.items()},
        jcompat.seg_matrix(segments, V), interpret=True,
    )  # [B, N] item-major
    ts = _t(slot)
    layout = ScreenLayout(segments, V, every_key=True)
    got = screen_block(ts["allow"], ts["out"], ts["defined"],
                       ScreenItems(_t(items), layout), layout)
    assert got.shape == (n_slots, n_items)  # slot-major: no transpose
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)


@pytest.mark.parametrize("screen_v", [None, 30, 40])
def test_cut_value_axis_matches_reference_matmul_screen(screen_v):
    """rows_vs_items / items_vs_row of make_screen_ops (mxu) with the value
    axis cut at screen_v: keys past the cut are skipped by the block form
    and evaluated on an empty segment by the row form."""
    rng = np.random.default_rng(3)
    slot, items = random_case(rng, 45, 11, SMALL)
    V = SMALL[-1][1]
    w = V if screen_v is None else screen_v
    ops = make_screen_ops(SMALL, "mxu", screen_v)
    want_block = ops.rows_vs_items({k: jnp.asarray(v) for k, v in items.items()},
                                   jnp.asarray(slot["allow"]), jnp.asarray(slot["out"]),
                                   jnp.asarray(slot["defined"]))
    rows_layout = ScreenLayout(SMALL, w, every_key=False)
    # both key rules share the packing, so one prepared item side serves both
    ts, ti = _t(slot), ScreenItems(_t(items), rows_layout)
    got_block = screen_block(ts["allow"], ts["out"], ts["defined"], ti, rows_layout)
    np.testing.assert_array_equal(got_block.numpy(), np.asarray(want_block))
    for n in range(3):
        want_row = ops.items_vs_row({k: jnp.asarray(v) for k, v in items.items()},
                                    jnp.asarray(slot["allow"][n]),
                                    jnp.asarray(slot["out"][n]),
                                    jnp.asarray(slot["defined"][n]))
        got_row = screen_block(ts["allow"][n:n + 1], ts["out"][n:n + 1],
                               ts["defined"][n:n + 1], ti,
                               ScreenLayout(SMALL, w, every_key=True))[0]
        np.testing.assert_array_equal(got_row.numpy(), np.asarray(want_row))


# -- screen_prep_plain: the layout and the key bitmasks -----------------------

def _bits(flags: np.ndarray, K: int) -> np.ndarray:
    """[KW, R] int32 bitmask words -> [R, K] bool."""
    w = flags.view(np.uint32).T  # [R, KW]
    bits = (w[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(w.shape[0], -1)[:, :K].astype(bool)


PREP_CASES = [("small", SMALL, 41), ("small-cut", SMALL, 25), ("wide", WIDE, 1433),
              ("wide-cut", WIDE, 1000), ("many", MANY, MANY[-1][1]),
              ("many-cut", MANY, MANY[-1][1] // 2)]


@pytest.mark.parametrize("every_key", [False, True])
@pytest.mark.parametrize("name,segments,width", PREP_CASES)
def test_prep_plain_matches_reference_escape_and_planes(name, segments, width, every_key):
    rng = np.random.default_rng(len(name) + width)
    slot, items = structured_case(rng, 33, 9, segments)
    K = len(segments)
    layout = ScreenLayout(segments, width, every_key=every_key)
    assert layout.KW == (2 if K > 32 else 1)
    # on_mask: the key rule
    want_on = np.array([every_key or lo < width for lo, _hi in segments])
    np.testing.assert_array_equal(_bits(layout.on_mask[:, None], K)[0], want_on)

    s = screen_prep_plain(*(torch.from_numpy(slot[k]) for k in ("allow", "out", "defined")),
                          layout)
    ti = _t(items)
    i = screen_prep_plain(ti["allow"], ti["out"], ti["defined"], layout,
                          escape=ti["escape"], custom_deny=ti["custom_deny"])
    for side, prep, planes in (("slot", s, slot), ("item", i, items)):
        words = prep["words"].numpy()
        bytes_ = prep["bytes"].numpy()
        flags = prep["flags"].numpy()
        R = planes["allow"].shape[0]
        assert words.shape == (layout.n_words, R) and bytes_.shape == (R, 32 * layout.n_words)
        assert flags.shape == (4, layout.KW, R)
        # bytes: the value plane re-laid, one bit per byte, 0 past a segment
        col = layout.bit_col
        want_bytes = np.where(col >= 0, planes["allow"][:, np.maximum(col, 0)], False)
        np.testing.assert_array_equal(bytes_, want_bytes.astype(np.int8), err_msg=side)
        # words: the same bits packed, every key segment on its own words
        np.testing.assert_array_equal(_bits(words, 32 * layout.n_words), bytes_ == 1)
        assert np.all(np.diff(layout.word_key) >= 0)  # keys in order, words contiguous
        for k, (lo, hi) in enumerate(segments):
            n_words = int((layout.word_key == k).sum())
            assert n_words == (max(min(hi, width) - min(lo, width), 0) + 31) // 32
        np.testing.assert_array_equal(_bits(flags[0], K), planes["defined"])
        np.testing.assert_array_equal(_bits(flags[1], K), planes["out"])
    # slot escape flags: the reference's escape_flags_m on the cut axis
    sm = jcompat.seg_matrix(segments, segments[-1][1])[:width]
    want_esc = np.asarray(jcompat.escape_flags_m(
        jnp.asarray(slot["allow"][:, :width]), jnp.asarray(slot["out"]),
        jnp.asarray(slot["defined"]), sm))
    np.testing.assert_array_equal(_bits(s["flags"].numpy()[2], K), want_esc)
    assert not _bits(s["flags"].numpy()[3], K).any()
    # item escape and deny: the pod's own planes
    np.testing.assert_array_equal(_bits(i["flags"].numpy()[2], K), items["escape"])
    np.testing.assert_array_equal(_bits(i["flags"].numpy()[3], K), items["custom_deny"])


# -- numpy emulations of the kernels -------------------------------------------

def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _group_ok(sd, so, se, id_, io, ie, idn, inter, on):
    """csrc/screen.cu's group_ok: one group of 32 keys of a pair."""
    ok = ~(sd & id_) | (so & io) | (se & ie) | inter | ~on
    return (ok == np.uint32(0xFFFFFFFF)) & ((idn & ~sd) == 0)


def _emulate_block(slot, items, layout):
    """screen_block_kernel in numpy: walk the words (k32 slabs) in order;
    each slab's int8 0/1 bytes accumulate s_bytes @ i_bytes^T in int32; at
    a key's last slab the accumulator is tested against 0 into the key's
    bit of the pair's 16-bit inter mask and reset; a finished half-group of
    16 keys folds into the verdict through the key-bitmask algebra on that
    half of the bitmask words. (The kernel reads a slab's bytes in one
    permuted order for both sides, which leaves every dot product as it
    is.)"""
    a = slot["bytes"].numpy().astype(np.int32)
    b = items["bytes"].numpy().astype(np.int32)
    sf, itf = _u32(slot["flags"]), _u32(items["flags"])
    on = layout.on_mask.view(np.uint32)
    N, B, W, key = a.shape[0], b.shape[0], layout.n_words, layout.word_key
    acc = np.zeros((N, B), np.int32)
    inter = np.zeros((N, B), np.uint32)
    fail = np.zeros((N, B), bool)
    half = np.uint32(0xFFFF)

    def fold(hq):
        q, sh = hq >> 1, np.uint32(16 * (hq & 1))
        sd, so, se = (sf[f, q][:, None] >> sh for f in range(3))
        id_, io, ie, idn = (itf[f, q][None] >> sh for f in range(4))
        ok = ((~(sd & id_) | (so & io) | (se & ie) | inter | ~(on[q] >> sh)) & half) == half
        ok &= (idn & ~sd & half) == 0
        fail[~ok] = True
        inter[:] = 0

    hq = 0
    for w in range(W):
        k = int(key[w])
        while hq < k >> 4:
            fold(hq)
            hq += 1
        acc += a[:, 32 * w: 32 * w + 32] @ b[:, 32 * w: 32 * w + 32].T
        if w + 1 == W or key[w + 1] != k:
            inter |= (acc != 0).astype(np.uint32) << np.uint32(k & 15)
            acc[:] = 0
    while hq < 2 * layout.KW:
        fold(hq)
        hq += 1
    return ~fail


def _emulate_row(one, one_row, many, one_is_slot, layout, parts=4):
    """screen_row_kernel in numpy: the single row's words (column one_row
    of its word-major planes) AND every row of the other side. Per key
    group, each of `parts` threads of a row takes every parts-th word of
    the group and sets a word's key bit where the AND is nonzero; the
    parts' bits are ORed and the group folds into the verdict. Returns [R]
    verdicts over the other side's rows."""
    ow, of = _u32(one["words"])[:, one_row], _u32(one["flags"])[:, :, one_row]
    mw, mf = _u32(many["words"]), _u32(many["flags"])
    on = layout.on_mask.view(np.uint32)
    W, key, R = layout.n_words, layout.word_key, mw.shape[1]
    # the first word of each key group (W past the last)
    starts = [next((w for w in range(W) if key[w] >> 5 >= q), W)
              for q in range(layout.KW + 1)]
    fail = np.zeros(R, bool)
    for q in range(layout.KW):
        inter = np.zeros(R, np.uint32)
        for part in range(parts):
            for w in range(starts[q] + part, starts[q + 1], parts):
                hit = (ow[w] & mw[w]) != 0
                inter |= hit.astype(np.uint32) << np.uint32(key[w] & 31)
        if one_is_slot:
            ok = _group_ok(of[0, q], of[1, q], of[2, q], mf[0, q], mf[1, q], mf[2, q],
                           mf[3, q], inter, on[q])
        else:
            ok = _group_ok(mf[0, q], mf[1, q], mf[2, q], of[0, q], of[1, q], of[2, q],
                           of[3, q], inter, on[q])
        fail |= ~ok
    return ~fail


EMU_CASES = [("small", SMALL, 29, 13), ("wide", WIDE, 24, 7), ("many", MANY, 31, 6)]


def _prepared(slot, items, layout):
    ts, ti = _t(slot), _t(items)
    s = screen_prep_plain(ts["allow"], ts["out"], ts["defined"], layout)
    i = screen_prep_plain(ti["allow"], ti["out"], ti["defined"], layout,
                          escape=ti["escape"], custom_deny=ti["custom_deny"])
    want = {ek: screen_plain(ts["allow"][:, : layout.width], ts["out"], ts["defined"],
                             dict(ti, allow=ti["allow"][:, : layout.width]),
                             layout.segments, ek).numpy()
            for ek in (False, True)}
    return s, i, want


@pytest.mark.parametrize("name,segments,n_slots,n_items", EMU_CASES)
def test_block_emulation_matches_plain_and_pallas(name, segments, n_slots, n_items):
    rng = np.random.default_rng(n_slots)
    slot, items = structured_case(rng, n_slots, n_items, segments)
    V = segments[-1][1]
    pallas = np.asarray(batched_slot_screen_pallas(
        jnp.asarray(slot["allow"]), jnp.asarray(slot["out"]),
        jnp.asarray(slot["defined"]), {k: jnp.asarray(v) for k, v in items.items()},
        jcompat.seg_matrix(segments, V), interpret=True,
    )).T
    for width in (V, V * 2 // 3):
        for every_key in (False, True):
            layout = ScreenLayout(segments, width, every_key=every_key)
            s, i, want = _prepared(slot, items, layout)
            got = _emulate_block(s, i, layout)
            np.testing.assert_array_equal(got, want[every_key], err_msg=f"{width} {every_key}")
            if width == V and every_key:
                np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("name,segments,n_slots,n_items", EMU_CASES)
def test_row_emulation_matches_plain_and_pallas(name, segments, n_slots, n_items):
    rng = np.random.default_rng(n_slots + 1)
    slot, items = structured_case(rng, n_slots, n_items, segments)
    V = segments[-1][1]
    sm = jcompat.seg_matrix(segments, V)
    for width in (V, V * 2 // 3):
        for every_key in (False, True):
            layout = ScreenLayout(segments, width, every_key=every_key)
            s, i, want = _prepared(slot, items, layout)
            for n in range(0, n_slots, 7):  # N = 1: one slot row against every item
                one = {k: s[k][..., n:n + 1] for k in ("words", "flags")}
                np.testing.assert_array_equal(
                    _emulate_row(one, 0, i, True, layout), want[every_key][n])
            for b in range(n_items):  # B = 1: every slot row against item b
                got = _emulate_row(i, b, s, False, layout)
                np.testing.assert_array_equal(got, want[every_key][:, b])
                if width == V and every_key:
                    pallas = slot_screen_pallas(
                        jnp.asarray(slot["allow"]), jnp.asarray(slot["out"]),
                        jnp.asarray(slot["defined"]),
                        {k: jnp.asarray(v[b]) for k, v in items.items()}, sm,
                        interpret=True)
                    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("every_key", [False, True])
@pytest.mark.parametrize("width", [41, 25, 10])
def test_packed_layout_reproduces_plain_screen(every_key, width):
    """Both kernel algorithms over screen_prep_plain's planes, with
    trailing empty and wide keys and a cut value axis."""
    rng = np.random.default_rng(width)
    segments = SMALL + [(41, 41), (41, 100)]  # trailing empty and wide keys
    slot, items = random_case(rng, 29, 13, segments)
    layout = ScreenLayout(segments, width, every_key=every_key)
    s, i, want = _prepared(slot, items, layout)
    np.testing.assert_array_equal(_emulate_block(s, i, layout), want[every_key])
    for b in range(13):
        np.testing.assert_array_equal(_emulate_row(i, b, s, False, layout),
                                      want[every_key][:, b])


def test_cpu_tensors_take_the_plain_version():
    screen.reset_launches()
    rng = np.random.default_rng(5)
    slot, items = random_case(rng, 20, 4, SMALL)
    ts = _t(slot)
    layout = ScreenLayout(SMALL, 41)
    ti = ScreenItems(_t(items), layout)
    assert ti.prepared is None  # CPU planes are never prepared
    screen_block(ts["allow"], ts["out"], ts["defined"], ti, layout)
    screen_block(ts["allow"][:1], ts["out"][:1], ts["defined"][:1], ti, layout)
    screen_row(ts["allow"], ts["out"], ts["defined"], ti, 2, layout)
    screen.screen_prep(ts["allow"], ts["out"], ts["defined"], layout)
    assert screen.LAUNCHES == {"screen": 0, "screen_prep": 0, "pack_scan": 0}
    assert screen.FORM_LAUNCHES == {"block": 0, "row_n1": 0, "row_b1": 0}


def test_items_serve_only_layouts_of_their_packing():
    """A ScreenItems is prepared in one layout's packing: the other key rule
    shares it, another width does not and is refused on every device."""
    rng = np.random.default_rng(6)
    slot, items = random_case(rng, 5, 3, SMALL)
    ts = _t(slot)
    ti = ScreenItems(_t(items), ScreenLayout(SMALL, 41))
    screen_block(ts["allow"], ts["out"], ts["defined"], ti,
                 ScreenLayout(SMALL, 41, every_key=True))
    with pytest.raises(ValueError):
        screen_block(ts["allow"], ts["out"], ts["defined"], ti, ScreenLayout(SMALL, 30))
    with pytest.raises(ValueError):
        screen_row(ts["allow"], ts["out"], ts["defined"], ti, 0, ScreenLayout(SMALL, 30))


def test_kernel_binding_declares_pointer_arguments(monkeypatch):
    """Both C entry points take 64-bit pointers and a stream: their ctypes
    signatures must be declared before the first call (undeclared, ctypes
    passes Python ints as C int and the launch faults on a cut pointer)."""
    from karpenter_core_tpu_torch.ops import cuda_build

    lib = ctypes.CDLL(None)  # any C function objects stand in
    lib.screen_prep_launch = lib.abs
    lib.screen_launch = lib.labs
    monkeypatch.setattr(cuda_build, "load", lambda name: lib)
    prep, scr = screen._c_kernels()
    p, i = ctypes.c_void_p, ctypes.c_int
    # allow/out/def/esc/deny with row strides; bit_col, word_key, words,
    # bytes, flags; R, W, K, KW; stream
    assert prep.argtypes == [p, i] * 5 + [p] * 5 + [i] * 4 + [p]
    # form; slot words/bytes/flags, item words/bytes/flags; i_ld, i_row;
    # on_mask, word_key, verdict; N, B, W, KW; stream
    assert scr.argtypes == [i] + [p] * 6 + [i] * 2 + [p] * 3 + [i] * 4 + [p]
    assert prep.restype is ctypes.c_int and scr.restype is ctypes.c_int


@pytest.mark.parametrize("segments,width", [
    ([(k, k + 1) for k in range(screen.MAX_KEYS + 1)], screen.MAX_KEYS + 1),
    ([(0, 32 * screen.MAX_WORDS + 1)], 32 * screen.MAX_WORDS + 1),
])
def test_layout_rejects_what_the_kernels_cannot_stage(segments, width):
    """The kernels stage the layout's word keys, the single row's words and
    the block's key bitmasks in shared memory: a layout past those sizes
    raises before any launch."""
    with pytest.raises(ValueError):
        ScreenLayout(segments, width)
    ScreenLayout(segments[:-1] or [(0, 32 * screen.MAX_WORDS)], width - 1)
