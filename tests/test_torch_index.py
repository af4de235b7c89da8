"""The port's offline index against the JAX package's on the CPU: the same
vectors through ``FlatL2Index`` / ``HammingIndex`` of both packages give
the same ids and distances in every storage mode, and an npz written by
either package is read and searched by the other.

Tolerances: genotype-like data (0/1, small integers) makes every distance
an exact float32 integer on both sides, so ids and values are equal.
Gaussian data: both sides are float32 expansions of the same distances,
summed in other orders; values agree to 1e-5 relative of |q|^2 + |r|^2
(observed ~1e-7) and ids where no two candidates lie that close.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_snvbert_tpu.index import FlatL2Index as JFlat
from rag_snvbert_tpu.index import HammingIndex as JHamming
from rag_snvbert_tpu.ops import l2_ref as jl2
from rag_snvbert_tpu_torch.index import FlatL2Index, HammingIndex
from rag_snvbert_tpu_torch.ops import l2_ref
from test_torch_modules import torch_one_thread  # noqa: F401  (autouse)

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8,
       "int4": jnp.int4}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
       "int4": "int4"}


def _genotypes(n, d, seed, hi=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, (n, d)).astype(np.float32)


def _pair(vectors, storage, align, **kw):
    if storage.startswith("pack"):
        pack = int(storage[4:])
        v = vectors.astype(np.int8)
        return (JFlat.build(v, pack=pack, align=align),
                FlatL2Index.build(v, pack=pack, align=align, device="cpu"))
    return (JFlat.build(vectors, dtype=JDT[storage], align=align),
            FlatL2Index.build(vectors, dtype=TDT[storage], align=align,
                              device="cpu"))


def _same(j, t):
    jv, ji = (np.asarray(x) for x in j)
    tv, ti = (x.numpy() for x in t)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    assert ti.dtype == np.int32 and tv.dtype == np.float32


STORAGES = ["f32", "bf16", "int8", "int4", "pack2", "pack4", "pack8"]


def _values(storage):
    """pack 2 stores 0..15, pack 4 0..3, int4 |v| <= 3: dosage-like data
    where the storage admits it, else binary genotypes."""
    return {"pack2": 16, "pack4": 4, "int4": 4}.get(storage, 2)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("storage", STORAGES)
def test_search_matches_jax(storage, align):
    hi = _values(storage)
    refs, q = _genotypes(300, 45, 0, hi), _genotypes(7, 45, 1, hi)
    j, t = _pair(refs, storage, align)
    assert (t.ntotal, t.d) == (j.ntotal, j.d) == (300, 45)
    assert tuple(t.vectors.shape) == tuple(j.vectors.shape)
    assert t.n_real == j.n_real and t.d_real == j.d_real
    np.testing.assert_array_equal(t.norms.numpy(), np.asarray(j.norms))
    for k in (1, 10):
        _same(j.search(q, k), t.search(q, k))
    # the kernel route on the CPU is the plain version: the same answers
    _same(j.search(q, 10), t.search(q, 10, use_pallas=True))
    # approx is answered exactly
    _same(j.search(q, 10), t.search(q, 10, approx=True))


@pytest.mark.parametrize("storage", STORAGES)
def test_masked_search_matches_jax_and_the_drop_columns_oracle(storage):
    hi = _values(storage)
    refs, q = _genotypes(200, 45, 2, hi), _genotypes(6, 45, 3, hi)
    mask = (np.random.default_rng(4).random(45) > 0.35).astype(np.float32)
    j, t = _pair(refs, storage, align=True)
    got = t.masked_search(q, mask, 8)
    _same(j.masked_search(q, jnp.asarray(mask), 8), got)
    keep = mask.astype(bool)
    d = ((q[:, None, keep] - refs[None, :, keep]) ** 2).sum(-1)
    want = np.argsort(d, axis=1, kind="stable")[:, :8]
    np.testing.assert_array_equal(got[1].numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.take_along_axis(d, want, 1))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("storage", ["f32", "int8", "pack8"])
def test_tombstones_are_never_ahead_of_a_live_row(storage, masked):
    refs, q = _genotypes(120, 33, 5), _genotypes(5, 33, 6)
    j, t = _pair(refs, storage, align=False)
    dead = [0, 7, 50, 51]
    j = j.replace(norms=j.norms.at[jnp.asarray(dead)].set(jnp.inf))
    t.norms[dead] = float("inf")
    mask = np.ones(33, np.float32)
    mask[::4] = 0
    if masked:
        jr, tr = (j.masked_search(q, jnp.asarray(mask), 116),
                  t.masked_search(q, mask, 116))
    else:
        jr, tr = j.search(q, 116), t.search(q, 116)
    _same(jr, tr)
    assert not np.isin(tr[1].numpy(), dead).any()


@pytest.mark.parametrize("n", [300, 150])          # 150 < k: the short tail
@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "pack8"])
def test_k_above_128_streams_like_jax(storage, n):
    refs, q = _genotypes(n, 40, 7), _genotypes(4, 40, 8)
    j, t = _pair(refs, storage, align=False)
    _same(j.search(q, 200), t.search(q, 200))
    mask = np.ones(40, np.float32)
    mask[:9] = 0
    _same(j.masked_search(q, jnp.asarray(mask), 200),
          t.masked_search(q, mask, 200))


@pytest.mark.parametrize("chunk", [64, 65536])
def test_streaming_chunks_and_filler_match_jax(chunk):
    rng = np.random.default_rng(9)
    refs = rng.standard_normal((150, 24)).astype(np.float32)
    q = rng.standard_normal((3, 24)).astype(np.float32)
    jv, ji = jl2.l2_topk_streaming(jnp.asarray(q), jnp.asarray(refs), 160,
                                   chunk=chunk)
    tv, ti = l2_ref.l2_topk_streaming(torch.from_numpy(q),
                                      torch.from_numpy(refs), 160,
                                      chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    scale = (q ** 2).sum(1)[:, None] + (refs ** 2).sum(1).max()
    fin = np.isfinite(np.asarray(jv))
    np.testing.assert_allclose(tv.numpy()[fin], np.asarray(jv)[fin],
                               atol=1e-5 * scale.max())
    # the (+inf, 0) filler past the 150 rows
    assert np.isinf(tv.numpy()[:, 150:]).all()
    assert (ti.numpy()[:, 150:] == 0).all()


def test_gaussian_float_search_matches_jax():
    rng = np.random.default_rng(10)
    refs = rng.standard_normal((400, 70)).astype(np.float32)
    q = rng.standard_normal((6, 70)).astype(np.float32)
    for storage in ("f32", "bf16"):
        j, t = _pair(refs, storage, align=True)
        jv, ji = (np.asarray(x) for x in j.search(q, 10))
        tv, ti = t.search(q, 10)
        np.testing.assert_array_equal(ti.numpy(), ji)
        scale = (q ** 2).sum(1)[:, None] + (refs ** 2).sum(1).max()
        np.testing.assert_allclose(tv.numpy(), jv, atol=1e-5 * scale.max())


@pytest.mark.parametrize("streaming", [False, True])
def test_hamming_matches_jax(streaming):
    bits = _genotypes(500, 77, 11).astype(np.int8)
    qb = _genotypes(9, 77, 12).astype(np.int8)
    j = JHamming.build(bits)
    t = HammingIndex.build(bits, device="cpu")
    np.testing.assert_array_equal(t.packed.numpy(),
                                  np.asarray(j.packed).astype(np.int64))
    jr = j.search(jnp.asarray(qb), 12, streaming=streaming, chunk=128)
    tr = t.search(torch.from_numpy(qb), 12, streaming=streaming, chunk=128)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # device-side packing of torch input gives the same words
    t2 = HammingIndex.build(torch.from_numpy(bits), device="cpu")
    assert torch.equal(t2.packed, t.packed)
    # invalid rows are never returned
    t.valid[:250] = False
    _, ids = t.search(torch.from_numpy(qb), 12, streaming=streaming,
                      chunk=128)
    assert (ids.numpy() >= 250).all()


@pytest.mark.parametrize("d", [1, 31, 32, 33, 77])
def test_pack_bits_matches_jax_and_the_host_version(d):
    bits = _genotypes(6, d, d).astype(np.int8)
    words = l2_ref.pack_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(words, l2_ref.pack_bits_np(bits))
    np.testing.assert_array_equal(words, np.asarray(jl2.pack_bits(
        jnp.asarray(bits))))
    assert l2_ref.pack_bits_np(bits).dtype == np.uint32


def test_hamming_distance_is_the_bit_count():
    rng = np.random.default_rng(13)
    a, b = rng.integers(0, 2, (4, 70)), rng.integers(0, 2, (5, 70))
    d = l2_ref.hamming_distances(l2_ref.pack_bits(torch.from_numpy(a)),
                                 l2_ref.pack_bits(torch.from_numpy(b)))
    np.testing.assert_array_equal(d.numpy(),
                                  (a[:, None] != b[None]).sum(-1))


@pytest.mark.parametrize("case", ["int8 over 63", "int4 over 3",
                                  "packed float", "packed range",
                                  "packed negative"])
def test_build_guards_raise_as_jax_does(case):
    v = np.zeros((4, 8), np.float32)
    if case == "int8 over 63":
        v[1, 2] = 64
        with pytest.raises(ValueError, match="max \\|value\\| 64 > 63"):
            FlatL2Index.build(v, dtype=torch.int8, device="cpu")
    elif case == "int4 over 3":
        v[0, 0] = -5
        with pytest.raises(ValueError, match="5 > 3"):
            FlatL2Index.build(v, dtype="int4", device="cpu")
    elif case == "packed float":
        with pytest.raises(TypeError, match="packed storage needs integer "
                                            "input, got float32"):
            FlatL2Index.build(v, pack=8, device="cpu")
    elif case == "packed range":
        with pytest.raises(ValueError, match="pack=4 admits values in "
                                             "\\[0, 4\\); data spans "
                                             "\\[4, 4\\]"):
            FlatL2Index.build(np.full((2, 3), 4, np.int8), pack=4,
                              device="cpu")
    else:
        with pytest.raises(ValueError, match="spans \\[-1, 0\\]"):
            FlatL2Index.build(-np.eye(3, dtype=np.int8), pack=8,
                              device="cpu")


def test_build_and_load_need_a_card_or_an_explicit_cpu(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlatL2Index.build(np.zeros((2, 3), np.float32))
    FlatL2Index.build(np.zeros((2, 3), np.float32), device="cpu").save(
        str(tmp_path / "x"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlatL2Index.load(str(tmp_path / "x"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HammingIndex.build(np.zeros((2, 3), np.int8))


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("storage", STORAGES)
def test_npz_written_by_either_package_serves_the_other(storage, align,
                                                        tmp_path):
    hi = _values(storage)
    refs, q = _genotypes(260, 45, 14, hi), _genotypes(5, 45, 15, hi)
    j, t = _pair(refs, storage, align)
    t.save(str(tmp_path / "port"))
    j.save(str(tmp_path / "jax"))
    z_t, z_j = (np.load(str(tmp_path / f"{n}.npz")) for n in ("port", "jax"))
    assert sorted(z_t.files) == sorted(z_j.files)
    for key in z_j.files:
        assert z_t[key].dtype == z_j[key].dtype, key
        np.testing.assert_array_equal(z_t[key], z_j[key], err_msg=key)
    from_jax = FlatL2Index.load(str(tmp_path / "jax.npz"), device="cpu")
    from_port = JFlat.load(str(tmp_path / "port"))
    assert from_jax.int4 == (storage == "int4")
    assert from_jax.vectors.dtype == t.vectors.dtype
    _same(j.search(q, 6), from_jax.search(q, 6))
    _same(from_port.search(q, 6), t.search(q, 6))


def test_files_from_before_round_3_still_load(tmp_path):
    refs, q = _genotypes(90, 20, 16), _genotypes(3, 20, 17)
    norms = (refs ** 2).sum(1).astype(np.float32)
    np.savez(str(tmp_path / "old.npz"), vectors=refs, norms=norms)
    t = FlatL2Index.load(str(tmp_path / "old"), device="cpu")
    j = JFlat.load(str(tmp_path / "old"))
    assert (t.n_real, t.d_real, t.pack, t.int4) == (None, None, 1, False)
    _same(j.search(q, 4), t.search(q, 4))


def test_hamming_npz_round_trips_between_packages(tmp_path):
    bits = _genotypes(70, 40, 18).astype(np.int8)
    qb = torch.from_numpy(_genotypes(3, 40, 19).astype(np.int8))
    t = HammingIndex.build(bits, device="cpu")
    t.valid[3] = False
    t.save(str(tmp_path / "h"))
    z = np.load(str(tmp_path / "h.npz"))
    assert z["packed"].dtype == np.uint32
    j = JHamming.load(str(tmp_path / "h"))
    back = HammingIndex.load(str(tmp_path / "h.npz"), device="cpu")
    for a, b in zip(j.search(jnp.asarray(qb.numpy()), 5),
                    back.search(qb, 5)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
