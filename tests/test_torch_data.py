"""The port's data layer (pytorch_operator_tpu_torch/data/) against the JAX
package's, on the CPU.

- The record format is the same byte for byte: a file packed by either
  package is the same file, and reads the same in both.
- For one file, seed and loader kind, the port's loader yields the JAX
  loader's batches in the same order, across epochs: the native loader
  (``native/loader.cc``, built by the port into ``build/native/``) against
  the JAX one, the Python fallback against the JAX fallback (the two kinds
  shuffle with different RNGs, so each is compared with its own kind).
- Records stay whole under the shuffle; short and ragged files and a batch
  larger than the file are refused up front by both kinds.
- ``pack --dataset text`` and ``synthetic`` write what the JAX tool writes;
  ``digits`` is refused by name.
"""

import numpy as np
import pytest

from pytorch_operator_tpu.data import array_file as jax_array_file
from pytorch_operator_tpu.data import native_loader as jax_loader
from pytorch_operator_tpu.data import pack as jax_pack
from pytorch_operator_tpu_torch import data as port_data
from pytorch_operator_tpu_torch.data import array_file as port_array_file
from pytorch_operator_tpu_torch.data import native_loader as port_loader
from pytorch_operator_tpu_torch.data import pack as port_pack


def _arrays(n=37, seq=24, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, 256, (n, seq)).astype(np.int32),
        "label": rng.integers(-5, 5, (n,)).astype(np.int64),
    }


@pytest.fixture
def packed(tmp_path):
    arrays = _arrays()
    path = tmp_path / "rec.bin"
    port_array_file.pack_arrays(path, arrays)
    return path, arrays


def test_packed_files_are_byte_identical(tmp_path, packed):
    path, arrays = packed
    jax_path = tmp_path / "jax.bin"
    jax_array_file.pack_arrays(jax_path, arrays)
    assert path.read_bytes() == jax_path.read_bytes()
    assert (
        port_array_file.meta_path(path).read_text()
        == jax_array_file.meta_path(jax_path).read_text()
    )
    for read_meta, field_range in (
        (jax_array_file.read_meta, jax_array_file.field_range),
        (port_array_file.read_meta, port_array_file.field_range),
    ):
        meta = read_meta(path)
        assert meta.n_records == 37 and meta.record_bytes == 24 * 4 + 8
        assert [int(x) for x in field_range(path, meta, "label", chunk_records=5)] == [
            int(arrays["label"].min()), int(arrays["label"].max()),
        ]
    raw = np.fromfile(jax_path, np.uint8)[: 3 * meta.record_bytes]
    for split in (jax_array_file.split_batch, port_array_file.split_batch):
        fields = split(meta, raw, 3)
        np.testing.assert_array_equal(fields["tokens"], arrays["tokens"][:3])
        np.testing.assert_array_equal(fields["label"], arrays["label"][:3])


def _stream(loader, n):
    out = []
    with loader as ld:
        for _ in range(n):
            epoch, index, fields = ld.next_batch()
            out.append((epoch, index, {k: np.array(v, copy=True) for k, v in fields.items()}))
    return out


@pytest.mark.parametrize("kind", ["native", "python"])
@pytest.mark.parametrize("seed", [0, 7])
def test_loader_batches_equal_jax_in_order(packed, kind, seed):
    """Three epochs of 4 batches of 8 (5 records left over each epoch)."""
    path, _ = packed
    native = kind == "native"
    port = port_loader.open_loader(path, 8, seed=seed, native=native)
    assert port.kind == kind
    got = _stream(port, 13)
    want = _stream(jax_loader.open_loader(path, 8, seed=seed, native=native), 13)
    assert [(e, i) for e, i, _ in got] == [(e, i) for e, i, _ in want]
    assert [e for e, _, _ in got] == [0] * 4 + [1] * 4 + [2] * 4 + [3]
    for (_, _, g), (_, _, w) in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("kind", ["native", "python"])
def test_records_stay_whole_under_shuffle(packed, kind):
    path, arrays = packed
    rows = {tuple(t) + (int(y),) for t, y in zip(arrays["tokens"], arrays["label"])}
    seen = []
    for _, _, fields in _stream(port_loader.open_loader(path, 9, seed=3, native=kind == "native"), 4):
        for t, y in zip(fields["tokens"], fields["label"]):
            seen.append(tuple(t) + (int(y),))
    # One epoch of 4 batches of 9: 36 distinct records, each whole.
    assert len(seen) == 36 and len(set(seen)) == 36 and set(seen) <= rows
    first = _stream(port_loader.open_loader(path, 9, seed=3, native=kind == "native"), 1)
    unshuffled = _stream(port_loader.open_loader(path, 9, shuffle=False, native=kind == "native"), 1)
    np.testing.assert_array_equal(unshuffled[0][2]["tokens"], arrays["tokens"][:9])
    assert not np.array_equal(first[0][2]["tokens"], unshuffled[0][2]["tokens"])


@pytest.mark.parametrize("kind", ["native", "python"])
def test_short_ragged_and_oversized_are_refused(tmp_path, packed, kind):
    path, _ = packed
    meta = port_array_file.read_meta(path)
    data = path.read_bytes()
    short = tmp_path / "short.bin"
    short.write_bytes(data[: len(data) // 2])
    ragged = tmp_path / "ragged.bin"
    ragged.write_bytes(data[:-3])  # the last record is cut inside a field
    for bad in (short, ragged):
        port_array_file.meta_path(bad).write_text(meta.to_json())
        with pytest.raises(port_loader.LoaderDataError):
            port_loader.open_loader(bad, 4, native=kind == "native")
        with pytest.raises(jax_loader.LoaderDataError):
            jax_loader.open_loader(bad, 4, native=kind == "native")
    with pytest.raises(port_loader.LoaderDataError):
        port_loader.open_loader(path, 38, native=kind == "native")
    # Bytes past the records the sidecar claims are tolerated, as in JAX.
    long = tmp_path / "long.bin"
    long.write_bytes(data + b"\0" * 5)
    port_array_file.meta_path(long).write_text(meta.to_json())
    assert len(_stream(port_loader.open_loader(long, 4, native=kind == "native"), 1)) == 1


def test_native_library_builds_under_build_dir():
    """The port builds ``native/loader.cc`` into its own ignored build
    directory, named by a hash of the source and flags, never into native/."""
    port_loader._load_lib()
    so = port_loader.library_path()
    assert so.exists() and so.parent.name == "native" and so.parent.parent.name == "build"
    assert so.name.startswith("libtpujob_loader-") and so.suffix == ".so"
    assert port_data.open_loader is port_loader.open_loader


def test_pack_text_equals_jax_and_refuses_image_datasets(tmp_path):
    src = tmp_path / "corpus.txt"
    src.write_bytes(bytes(range(256)) * 3 + b"tail")
    assert port_pack.main(["--dataset", "text", "--input", str(src), "--seq-len", "100",
                           "--out", str(tmp_path / "p.bin")]) == 0
    assert jax_pack.main(["--dataset", "text", "--input", str(src), "--seq-len", "100",
                          "--out", str(tmp_path / "j.bin")]) == 0
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    meta = port_array_file.read_meta(tmp_path / "p.bin")
    assert meta.n_records == 7 and meta.fields[0].shape == (100,)
    # digits (the port's own copy of scikit-learn's data file) and synthetic
    # write the JAX tool's bytes.
    digits = ["--dataset", "digits", "--split", "test"]
    assert port_pack.main(digits + ["--out", str(tmp_path / "pd.bin")]) == 0
    assert jax_pack.main(digits + ["--out", str(tmp_path / "jd.bin")]) == 0
    assert (tmp_path / "pd.bin").read_bytes() == (tmp_path / "jd.bin").read_bytes()
    syn = ["--dataset", "synthetic", "--n", "6", "--height", "4", "--width", "6", "--classes", "5"]
    assert port_pack.main(syn + ["--out", str(tmp_path / "ps.bin")]) == 0
    assert jax_pack.main(syn + ["--out", str(tmp_path / "js.bin")]) == 0
    assert (tmp_path / "ps.bin").read_bytes() == (tmp_path / "js.bin").read_bytes()
