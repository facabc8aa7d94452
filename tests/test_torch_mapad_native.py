"""The mapAD-native index format in mapad_tpu_torch against mapad_tpu: the
JAX package's own cases run on the port, `save_mapad_index` writes the same
bytes in both packages, each loads the other's files into equal arrays,
the port's C++ snappy decoder (csrc/host/snappy.cpp) agrees with its plain
Python one, `load_index` falls back to a mapAD-native index (and names a
partial one), and `index --mapad_format` runs through the port's CLI."""

import os
import shutil

import numpy as np
import pytest

from mapad_tpu.index import mapad_native as jmn
from mapad_tpu.index.builder import build_from_sequences as j_build
from mapad_tpu_torch.errors import InvalidIndex
from mapad_tpu_torch.index import mapad_native as tmn
from mapad_tpu_torch.index.builder import build_from_sequences as t_build
from mapad_tpu_torch.index.runtime import load_index
from torch_port_helpers import port_twin

# tests/test_mapad_native.py's cases (and the fixture they share) on the
# port's modules
_TWIN = port_twin("test_mapad_native")
globals().update({k: v for k, v in _TWIN.items() if k.startswith("test_")})
built = _TWIN["built"]

SUFFIXES = (*tmn.MAPAD_SUFFIXES, ".toc")


def _sequences(seed):
    rng = np.random.default_rng(seed)
    seqs = []
    for i, n in enumerate((2500, 1800, 700)):
        s = bytearray(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))
        s[50 + 7 * i : 53 + 7 * i] = b"NRY"  # ambiguous bases
        seqs.append((f"contig{i}", bytes(s)))
    return seqs


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """One genome indexed by each package and saved in mapAD's format.
    -> (port prefix, JAX prefix)."""
    d = tmp_path_factory.mktemp("mapad_native")
    prefixes = []
    for tag, build, mn in (("port", t_build, tmn), ("jax", j_build, jmn)):
        prefix = str(d / tag / "ref.fa")
        os.makedirs(os.path.dirname(prefix))
        mn.save_mapad_index(prefix, *build(_sequences(5)))
        prefixes.append(prefix)
    return tuple(prefixes)


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_port_writes_the_jax_packages_files(both, suffix):
    ours, theirs = both
    with open(ours + suffix, "rb") as a, open(theirs + suffix, "rb") as b:
        assert a.read() == b.read()


def _arrays(index):
    ssa = index.suffix_array
    return {
        "bwt": np.asarray(index.fmd.bwt), "less": np.asarray(index.fmd.less),
        "occ_cp": np.asarray(index.fmd.occ_cp), "occ_k": index.fmd.occ_k,
        "sentinel_occ": np.asarray(index.fmd.sentinel_occ),
        "sample": np.asarray(ssa.sample), "rate": ssa.sampling_rate,
        "extra_keys": np.asarray(ssa.extra_keys),
        "extra_vals": np.asarray(ssa.extra_vals),
        "contigs": [(c.start, c.end, c.identifier)
                    for c in index.id_pos_map],
        "orig_pos": np.asarray(index.original_symbols.positions),
        "orig_sym": np.asarray(index.original_symbols.symbols),
        "meta": index.meta,
    }


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_port_loads_the_jax_packages_files(both, writer):
    """Each package's files, loaded by either, give equal arrays."""
    prefix = both[0] if writer == "port" else both[1]
    ours, theirs = (_arrays(tmn.load_mapad_index(prefix)),
                    _arrays(jmn.load_mapad_index(prefix)))
    assert ours.keys() == theirs.keys()
    for key in ours:
        if isinstance(ours[key], np.ndarray):
            np.testing.assert_array_equal(ours[key], theirs[key], key)
        else:
            assert ours[key] == theirs[key], key
    occ, k = tmn.load_mapad_occ(prefix + ".toc")
    jocc, jk = jmn.load_mapad_occ(prefix + ".toc")
    assert k == jk and np.array_equal(occ, jocc)


def _varint(n):
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def _random_block(rng, n_ops):
    """A raw snappy block of random literals (every length form) and copies
    (1-, 2- and 4-byte offsets, overlapping ones too) -> (block, plain)."""
    plain = bytearray()
    body = bytearray()
    for op in range(n_ops):
        kind = 0 if not plain else int(rng.integers(0, 4))
        if kind == 0:
            ln = int(rng.choice([1, 7, 60, 61, 300, 70000])) if op % 5 else 60
            lit = bytes(rng.integers(0, 256, ln, dtype=np.uint8))
            if ln <= 60:
                body += bytes([(ln - 1) << 2])
            else:
                nb = ((ln - 1).bit_length() + 7) // 8
                body += bytes([(59 + nb) << 2]) + (ln - 1).to_bytes(nb,
                                                                     "little")
            body += lit
            plain += lit
            continue
        if kind == 1:
            ln = int(rng.integers(4, 12))
            off = int(rng.integers(1, min(len(plain), 2047) + 1))
            body += bytes([((off >> 8) << 5) | ((ln - 4) << 2) | 1, off & 0xFF])
        else:
            ln = int(rng.integers(1, 65))
            off = int(rng.integers(1, min(len(plain), 65535) + 1))
            if kind == 2:
                body += bytes([((ln - 1) << 2) | 2]) + off.to_bytes(2, "little")
            else:
                body += bytes([((ln - 1) << 2) | 3]) + off.to_bytes(4, "little")
        for _ in range(ln):  # byte by byte: overlapping copies repeat
            plain.append(plain[-off])
    return _varint(len(plain)) + bytes(body), bytes(plain)


@pytest.mark.parametrize("seed", range(4))
def test_port_native_snappy_agrees_with_the_python_decoder(seed):
    assert tmn._native_snappy() is not None, "g++ could not build snappy"
    rng = np.random.default_rng(seed)
    block, plain = _random_block(rng, 40 + 30 * seed)
    assert tmn.snappy_block_decompress(block) == plain  # the C++ decoder
    assert tmn._snappy_block_decompress_py(block) == plain
    assert jmn._snappy_block_decompress_py(block) == plain
    # in a frame stream: a compressed chunk between uncompressed ones
    crc = tmn._masked_crc(plain).to_bytes(4, "little")
    chunk = bytes([0x00]) + (len(block) + 4).to_bytes(3, "little")
    framed = tmn.snappy_frame_compress(b"head")
    framed += chunk + crc + block + tmn.snappy_frame_compress(b"tail")[10:]
    assert tmn.snappy_frame_decompress(framed) == b"head" + plain + b"tail"
    assert jmn.snappy_frame_decompress(framed) == b"head" + plain + b"tail"
    # the C++ decoder refuses a block cut short
    with pytest.raises(InvalidIndex):
        tmn.snappy_block_decompress(block[:-3])


def test_port_load_index_falls_back_to_a_mapad_native_index(both, tmp_path):
    """With no .tpx bundle `load_index` reads mapAD's own files; with some
    of them missing it names the partial index, in the JAX package's
    words."""
    from mapad_tpu.index.runtime import load_index as j_load_index

    prefix = str(tmp_path / "ref.fa")
    for s in SUFFIXES:
        shutil.copy(both[1] + s, prefix + s)
    assert not os.path.exists(prefix + ".tpx")
    idx = load_index(prefix)
    assert idx.meta["format"] == "mapad-native"
    want = _arrays(jmn.load_mapad_index(both[1]))
    got = _arrays(idx)
    for key in ("bwt", "less", "sample", "extra_keys", "orig_pos"):
        np.testing.assert_array_equal(got[key], want[key], key)
    assert got["contigs"] == want["contigs"]

    for s in (".tsa", ".tos"):
        os.remove(prefix + s)
    with pytest.raises(InvalidIndex, match="partial mapAD-native") as ours:
        load_index(prefix)
    with pytest.raises(Exception) as theirs:
        j_load_index(prefix)
    assert str(ours.value) == str(theirs.value)
    assert "'.tsa', '.tos'" in str(ours.value)

    with pytest.raises(InvalidIndex, match="Run the `index` subcommand "
                                           "first.$"):
        load_index(str(tmp_path / "nothing.fa"))


def test_port_cli_index_mapad_format(tmp_path):
    """As tests/test_cli.py's case, through the port's CLI; the files equal
    those the JAX package's CLI writes for the same FASTA."""
    from mapad_tpu.cli import main as j_main
    from mapad_tpu_torch.cli import main as t_main

    rng = np.random.default_rng(3)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 3000))
    prefixes = {}
    for tag, main in (("port", t_main), ("jax", j_main)):
        fa = tmp_path / tag / "g.fa"
        fa.parent.mkdir()
        fa.write_text(f">c1\n{seq[:2000]}\n>c2\n{seq[2000:]}NNN\n")
        assert main(["index", "-g", str(fa), "--mapad_format"]) == 0
        prefixes[tag] = str(fa)
    fa = prefixes["port"]
    assert tmn.is_mapad_native_index(fa)
    ours, theirs = load_index(fa), tmn.load_mapad_index(fa)
    np.testing.assert_array_equal(ours.fmd.bwt, theirs.fmd.bwt)
    np.testing.assert_array_equal(np.asarray(ours.suffix_array.sample),
                                  np.asarray(theirs.suffix_array.sample))
    assert [c.identifier for c in ours.id_pos_map] == ["c1", "c2"]
    assert [c.identifier for c in theirs.id_pos_map] == ["c1", "c2"]
    for s in SUFFIXES:
        with open(fa + s, "rb") as a, open(prefixes["jax"] + s, "rb") as b:
            assert a.read() == b.read(), s
