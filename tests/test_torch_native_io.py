"""The port's native IO layer (ccsx_tpu_torch/native) against the port's own
Python readers and against the JAX package's native layer, on the same files.

The port twin of tests/test_native_io.py (and of tests/test_fuzz_ingest.py's
native/Python salvage parity): every stream the Python readers parse, the
port's native reader parses to identical records and holes, and so does the
JAX package's native reader; a damaged stream fails in both native readers
with the same taxonomy reason (io/corruption.py) and the same message; the
async writer writes what the Python writer writes.  Records, holes, bytes
and reasons: exact equality.  Skipped, with the loader's reason, where the
library cannot build (no g++ or no zlib).
"""

import gzip

import numpy as np
import pytest

from ccsx_tpu import native as jnative
from ccsx_tpu.config import CcsConfig as JaxConfig
from ccsx_tpu.utils.metrics import Metrics as JaxMetrics

from ccsx_tpu_torch import native
from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.io import bam as bam_mod
from ccsx_tpu_torch.io import fastx, zmw
from ccsx_tpu_torch.io.corruption import REASONS, SalvageSink
from ccsx_tpu_torch.ops import encode as enc
from ccsx_tpu_torch.pipeline import run
from ccsx_tpu_torch.utils.metrics import Metrics


@pytest.fixture(autouse=True)
def _native_built():
    if not native.available():
        pytest.skip(f"native library unavailable: {native.build_error()}")


def _jax_io():
    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")
    from ccsx_tpu.native import io as jio

    return jio


def _drain(records):
    """(name, comment, seq, qual) tuples read before the stream ended, and
    the error that ended it (None at a clean end)."""
    got, err = [], None
    try:
        for r in records:
            got.append((r.name, r.comment, r.seq, r.qual))
    except Exception as e:
        err = e
    return got, err


FASTA = b""">m1/1/0_5 first comment here
ACGTA
>m1/1/5_9
CG
TA
>m1/2/0_4\tx
GGGG
"""

FASTQ = b"""@m2/7/0_4 c
ACGT
+
IIII
@m2/7/4_10
AAC
GTT
+anything
IIIII
I
"""


def _bam_records(n=40, seqlen=300):
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        seq = rng.choice(list(b"ACGT"), seqlen).astype(np.uint8).tobytes()
        out.append((f"mv/{i // 4}/{i}_{i + seqlen}", seq, b"\x20" * seqlen))
    return out


def _write(tmp_path, kind):
    """The file of one input kind, and whether it is a BAM."""
    if kind == "fasta":
        p = tmp_path / "a.fa"
        p.write_bytes(FASTA)
    elif kind == "fastq":
        p = tmp_path / "a.fq"
        p.write_bytes(FASTQ)
    elif kind == "gzip":
        p = tmp_path / "a.fa.gz"
        p.write_bytes(gzip.compress(FASTA + FASTQ))
    else:
        p = tmp_path / "a.bam"
        bam_mod.write_bam(str(p), _bam_records(), bgzf=kind == "bgzf")
    return str(p), kind in ("bam", "bgzf")


@pytest.mark.parametrize("kind", ["fasta", "fastq", "gzip", "bam", "bgzf"])
def test_records_equal_python_and_jax_native(kind, tmp_path):
    from ccsx_tpu_torch.native.io import read_records_native

    path, is_bam = _write(tmp_path, kind)
    got, err = _drain(read_records_native(path, is_bam))
    py = (bam_mod.read_bam_records(path) if is_bam
          else fastx.read_fastx(path))
    assert err is None and got == _drain(py)[0]
    assert got == _drain(_jax_io().read_records_native(path, is_bam))[0]
    if kind == "bgzf":
        # several BGZF members: the block-parallel inflate ran
        assert open(path, "rb").read().count(b"\x1f\x8b\x08\x04") >= 2
    if kind == "fastq":
        assert [g[3] for g in got] == [b"IIII", b"IIIIII"]


def _damage(tmp_path, case):
    """A damaged input of one kind: (path, is_bam)."""
    if case == "gzip_truncated":
        p = tmp_path / "trunc.fa.gz"
        blob = gzip.compress(FASTA * 50)
        p.write_bytes(blob[: len(blob) // 2])
        return str(p), False
    if case == "fastq_bad_quality":
        p = tmp_path / "bad.fq"
        p.write_bytes(b"@r/1/0_4\nACGT\n+\nII\n")
        return str(p), False
    p = tmp_path / "b.bam"
    if case == "bam_truncated":
        bam_mod.write_bam(str(p), [("m/1/0", b"ACGTACGT", b"\x10" * 8)],
                          bgzf=False)
        raw = gzip.decompress(p.read_bytes())
        p.write_bytes(gzip.compress(raw[:-3]))
        return str(p), True
    bam_mod.write_bam(str(p), _bam_records(n=20), bgzf=True)
    raw = bytearray(p.read_bytes())
    if case == "bgzf_flipped_byte":
        raw[len(raw) // 2] ^= 0xFF
    elif case == "bgzf_cut_mid_block":
        raw = raw[: len(raw) // 2 + 7]
    elif case == "bgzf_missing_eof":
        assert bytes(raw).endswith(bam_mod.BGZF_EOF)
        raw = raw[: -len(bam_mod.BGZF_EOF)]
    elif case == "bgzf_huge_isize":
        bsize = int.from_bytes(raw[16:18], "little") + 1
        raw[bsize - 4: bsize] = (0xFFFFFFFF).to_bytes(4, "little")
    p.write_bytes(bytes(raw))
    return str(p), True


@pytest.mark.parametrize("case", [
    "gzip_truncated", "fastq_bad_quality", "bam_truncated",
    "bgzf_flipped_byte", "bgzf_cut_mid_block", "bgzf_missing_eof",
    "bgzf_huge_isize"])
def test_damaged_input_fails_like_the_jax_native_reader(case, tmp_path):
    """The stream error carries a reason of the taxonomy; the JAX package's
    native reader yields the same records first and fails with the same
    reason and message."""
    from ccsx_tpu_torch.native.io import NativeStreamError, read_records_native

    path, is_bam = _damage(tmp_path, case)
    got, err = _drain(read_records_native(path, is_bam))
    want, jerr = _drain(_jax_io().read_records_native(path, is_bam))
    assert isinstance(err, NativeStreamError)
    assert err.reason in REASONS
    assert got == want
    assert (type(jerr).__name__, jerr.reason, str(jerr)) == \
        ("NativeStreamError", err.reason, str(err))


def _mkfasta(tmp_path, holes):
    """holes: list of (movie, hole, [seqlens]) -> path"""
    rng = np.random.default_rng(0)
    lines = []
    for movie, hole, lens in holes:
        for i, ln in enumerate(lens):
            seq = "".join(rng.choice(list("ACGT"), ln).tolist())
            lines.append(f">{movie}/{hole}/{i}\n{seq}\n")
    p = tmp_path / "z.fa"
    p.write_text("".join(lines))
    return str(p)


def _holes(stream):
    return [(z.movie, z.hole, z.seqs, z.lens.tolist(), z.offs.tolist())
            for z in stream]


@pytest.mark.parametrize("streamer", ["stream_zmws_native",
                                      "stream_zmws_prefetch"])
def test_zmw_stream_filters_and_exclusion(streamer, tmp_path):
    """Group-by-hole, the count and length filters and -X: the same holes
    as the Python streamer and the JAX package's native streamer, and the
    same filtered-hole accounting."""
    from ccsx_tpu_torch.native import io as nio

    p = _mkfasta(tmp_path, [
        ("m1", "1", [200] * 6),
        ("m1", "2", [50] * 5),            # total 250: kept
        ("m1", "3", [300] * 3),           # too few passes
        ("m1", "4", [10] * 5),            # total 50 < 100
        ("m1", "5", [400] * 6),           # excluded by -X
        ("m2", "1", [400] * 7),
        ("m2", "6", [90000] * 6),         # total > max
    ] + [(f"m{i % 3}", str(10 + i), [150 + i] * 6) for i in range(30)])
    kw = dict(is_bam=False, min_subread_len=100, max_subread_len=500000,
              exclude_holes=frozenset({"5"}))
    m, pm, jm = Metrics(), Metrics(), JaxMetrics()
    extra = {"queue_cap": 4} if streamer.endswith("prefetch") else {}
    got = _holes(getattr(nio, streamer)(p, CcsConfig(**kw), metrics=m,
                                        **extra))
    want = _holes(zmw.stream_zmws(fastx.read_fastx(p), CcsConfig(**kw),
                                  metrics=pm))
    jgot = _holes(getattr(_jax_io(), streamer)(p, JaxConfig(**kw),
                                               metrics=jm, **extra))
    assert got == want == jgot
    assert [h[1] for h in got[:3]] == ["1", "2", "1"]
    assert m.holes_filtered == pm.holes_filtered == jm.holes_filtered == 4
    assert m.filtered_reasons == jm.filtered_reasons == {
        "few_passes": 1, "too_short": 1, "too_long": 1, "excluded": 1}


@pytest.mark.parametrize("streamer", ["stream_zmws_native",
                                      "stream_zmws_prefetch"])
def test_zmw_invalid_name_kills_the_stream(streamer, tmp_path):
    from ccsx_tpu_torch.native import io as nio

    p = tmp_path / "bad.fa"
    p.write_text(">m/1/0\nACGT\n>notaholename\nACGT\n")
    cfg = CcsConfig(is_bam=False, min_subread_len=0)
    with pytest.raises(zmw.InvalidZmwName):
        list(getattr(nio, streamer)(str(p), cfg))
    with pytest.raises(zmw.InvalidZmwName):
        list(zmw.stream_zmws(fastx.read_fastx(str(p)), cfg))


def test_prefetch_early_close(tmp_path):
    """Dropping the iterator mid-stream must not hang the producer
    thread."""
    from ccsx_tpu_torch.native.io import stream_zmws_prefetch

    cfg = CcsConfig(is_bam=False, min_subread_len=0)
    p = _mkfasta(tmp_path, [("m", str(i), [200] * 6) for i in range(50)])
    it = stream_zmws_prefetch(p, cfg, queue_cap=2)
    next(it)
    it.close()


def test_open_zmw_stream_takes_the_native_branch(tmp_path, monkeypatch):
    """A real path goes through the native prefetch reader, stdin ('-')
    and a missing library through the Python readers; the holes are the
    same either way."""
    from ccsx_tpu_torch.native import io as nio

    p = _mkfasta(tmp_path, [("m", str(i), [200] * 6) for i in range(4)])
    cfg = CcsConfig(is_bam=False, min_subread_len=100)
    calls = []
    real = nio.stream_zmws_prefetch
    monkeypatch.setattr(nio, "stream_zmws_prefetch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = _holes(run.open_zmw_stream(p, cfg))
    assert calls == [1]
    monkeypatch.setattr(native, "available", lambda: False)
    assert _holes(run.open_zmw_stream(p, cfg)) == got
    assert calls == [1] and len(got) == 4


@pytest.mark.parametrize("qual", [False, True])
def test_native_writer_equals_the_python_writer(qual, tmp_path):
    """FASTA and FASTQ records in put() order, then an appended one: the
    Python writer's bytes."""
    from ccsx_tpu_torch.native.io import NativeFastaWriter

    recs = [(f"m/{i}/ccs", b"ACGT" * (i % 7 + 1)) for i in range(300)]
    p, q = tmp_path / "n.fa", tmp_path / "p.fa"
    w, pw = NativeFastaWriter(str(p)), run.open_writer(str(q), False,
                                                       journaled=True)
    assert isinstance(pw, run._PyWriter)
    for k, (name, seq) in enumerate(recs + [("m/extra/ccs", b"TTTT")]):
        if k == len(recs):
            w.close()
            pw.close()
            w = NativeFastaWriter(str(p), append=True)
            pw = run.open_writer(str(q), True, journaled=True)
        qv = bytes(33 + (i % 40) for i in range(len(seq))) if qual else None
        w.put(name, seq, qv)
        pw.put(name, seq, qv)
    w.close()
    pw.close()
    assert p.read_bytes() == q.read_bytes()
    assert p.read_bytes().count(b"m/extra/ccs") == 1


def test_native_writer_refusals(tmp_path):
    from ccsx_tpu_torch.native.io import NativeFastaWriter

    with pytest.raises(OSError):
        NativeFastaWriter(str(tmp_path / "no-dir" / "y.fa"))
    w = NativeFastaWriter(str(tmp_path / "o.fq"))
    with pytest.raises(ValueError, match="qual length"):
        w.put("m/1/ccs", b"ACGT", b"II")
    w.close()
    with pytest.raises(ValueError, match="closed"):
        w.put("m/1/ccs", b"ACGT")


def test_open_writer_picks_the_jax_packages_writer(tmp_path):
    """--bam: the BAM writer (refusing stdout and append); a real path of
    a run that is not journaled: the native writer; otherwise Python."""
    from ccsx_tpu_torch.native.io import NativeFastaWriter

    out = str(tmp_path / "o.fa")
    w = run.open_writer(out, False, bam=True)
    assert isinstance(w, bam_mod.BamWriter)
    w.close()
    for path, append in (("-", False), (out, True)):
        with pytest.raises(OSError, match="--bam"):
            run.open_writer(path, append, bam=True)
    w = run.open_writer(out, False)
    assert isinstance(w, NativeFastaWriter)
    w.close()
    assert isinstance(run.open_writer("-", False), run._PyWriter)


def test_encode_revcomp_native():
    from ccsx_tpu_torch.native.io import encode_native, revcomp_codes_native

    seq = b"ACGTNacgtnXYZ-"
    np.testing.assert_array_equal(encode_native(seq), enc.encode(seq))
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 5, 257).astype(np.uint8)
    np.testing.assert_array_equal(
        revcomp_codes_native(codes), enc.revcomp_codes(codes))


def test_bgzf_threaded_matches_inline_and_pool_bench(tmp_path, monkeypatch):
    """CCSX_BGZF_THREADS=4 (the inflate pool) and =1 (inline) give the same
    records; the exported pool bench reads a well-formed file and refuses a
    damaged one."""
    from ccsx_tpu_torch.native.io import read_records_native

    p = str(tmp_path / "b.bam")
    bam_mod.write_bam(p, _bam_records(n=60), bgzf=True)
    monkeypatch.setenv("CCSX_BGZF_THREADS", "1")
    a = _drain(read_records_native(p, is_bam=True))
    monkeypatch.setenv("CCSX_BGZF_THREADS", "4")
    b = _drain(read_records_native(p, is_bam=True))
    assert a == b and a[1] is None and len(a[0]) == 60
    L = native.lib()
    assert L.ccsx_bgzf_pool_bench(p.encode(), 2, 1) > 0
    bad, _ = _damage(tmp_path, "bgzf_cut_mid_block")
    assert L.ccsx_bgzf_pool_bench(bad.encode(), 1, 1) < 0


# ---- salvage-mode parity (the port twin of tests/test_fuzz_ingest.py's) ---


def _salvage(streamer, path, cfg, metrics):
    return ([(z.movie, z.hole, tuple(int(x) for x in z.lens), z.seqs)
             for z in streamer(str(path), cfg, metrics=metrics)],
            dict(metrics.corrupt_reasons), metrics.holes_corrupt)


def _salvage_python(path, cfg):
    m = Metrics()
    sink = SalvageSink(m)
    records = (bam_mod.read_bam_records(str(path), salvage=sink)
               if cfg.is_bam else fastx.read_fastx(str(path), salvage=sink))
    holes = [(z.movie, z.hole, tuple(int(x) for x in z.lens), z.seqs)
             for z in zmw.stream_zmws(records, cfg, metrics=m, salvage=sink)]
    return holes, dict(m.corrupt_reasons), m.holes_corrupt


def _salvage_base(tmp_path, ext):
    rng = np.random.default_rng(11)
    if ext == "bam":
        recs = []
        for i in range(48):
            ln = int(rng.integers(150, 400))
            seq = rng.choice(list(b"ACGT"), ln).astype(np.uint8).tobytes()
            recs.append((f"mv/{i // 6}/{i}_{i + ln}", seq, b"I" * ln))
        base = tmp_path / "base.bam"
        payload = bam_mod.BGZF_BLOCK_PAYLOAD
        bam_mod.BGZF_BLOCK_PAYLOAD = 2048   # many blocks to resync across
        try:
            bam_mod.write_bam(str(base), recs, bgzf=True)
        finally:
            bam_mod.BGZF_BLOCK_PAYLOAD = payload
        return base.read_bytes()
    out = []
    for i in range(30):
        ln = int(rng.integers(40, 300))
        seq = rng.choice(list(b"ACGT"), ln).astype(np.uint8).tobytes()
        if ext == "fq":
            qual = bytes(33 + rng.integers(0, 60, ln, dtype=np.uint8))
            out.append(b"@mv/%d/%d_%d c\n%s\n+\n%s\n"
                       % (i // 6, i, i + ln, seq, qual))
        else:
            body = b"\n".join(seq[j: j + 70] for j in range(0, ln, 70))
            out.append(b">mv/%d/%d_%d\n%s\n" % (i // 6, i, i + ln, body))
    return b"".join(out)


@pytest.mark.parametrize("ext", ["bam", "fq", "fa"])
def test_salvage_parity_with_python_and_jax(ext, tmp_path):
    """Seeded mutants (a flipped bit, a cut, a zeroed run) through the
    port's native streamer under --salvage: the port's Python salvage
    readers and the JAX package's native streamer salvage the same holes
    with the same reason buckets."""
    from ccsx_tpu_torch.native.io import stream_zmws_native

    jio = _jax_io()
    data = _salvage_base(tmp_path, ext)
    kw = dict(min_subread_len=1, is_bam=ext == "bam", salvage=True)
    rng = np.random.default_rng({"bam": 5000, "fq": 6000, "fa": 7000}[ext])
    events = 0
    for i in range(12):
        mut = bytearray(data)
        if i % 3 == 0:
            pos = int(rng.integers(0, len(data)))
            mut[pos] ^= 1 << int(rng.integers(0, 8))
        elif i % 3 == 1:
            mut = mut[:int(rng.integers(1, len(data)))]
        else:
            pos = int(rng.integers(0, max(len(data) - 64, 1)))
            ln = int(rng.integers(4, 64))
            mut[pos:pos + ln] = b"\x00" * min(ln, len(mut) - pos)
        if ext == "fa" and i == 11:
            # plain FASTA has no checksum: a bad hole name is sure to be
            # an event
            mut = bytearray(data.replace(b">mv/2/", b">mvx2x", 1))
        elif ext == "fq" and i == 11:
            # and so is a quality line longer than its sequence
            head, _, rest = data.partition(b"\n+\n")
            mut = bytearray(head + b"\n+\nI" + rest)
        p = tmp_path / f"s{i}.{ext}"
        p.write_bytes(bytes(mut))
        got = _salvage(stream_zmws_native, p, CcsConfig(**kw), Metrics())
        assert got == _salvage_python(p, CcsConfig(**kw)), i
        assert got == _salvage(jio.stream_zmws_native, p, JaxConfig(**kw),
                               JaxMetrics()), i
        events += got[2]
    assert events > 0
