"""CLI end-to-end: preprocess a FASTA, search it, parse the report, check
scores against the numpy oracle."""

import re

import numpy as np
import pytest

from oswald_tpu.alphabet import ALPHABET, encode
from oswald_tpu.submat import get_submat
from oswald_tpu.core import sw_score_numpy
from oswald_tpu.cli import main

from conftest import random_protein


@pytest.fixture
def fasta_db(tmp_path, rng):
    n = 40
    seqs = [random_protein(rng, int(l))
            for l in rng.integers(5, 120, size=n)]
    path = tmp_path / "db.fasta"
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">dbseq{i} test protein {i}\n")
            body = "".join(ALPHABET[c] for c in s)
            for j in range(0, len(body), 60):
                f.write(body[j:j + 60] + "\n")
    return path, seqs


def test_cli_preprocess_search_info(tmp_path, fasta_db, rng, capsys):
    db_fasta, seqs = fasta_db
    qseq = seqs[7][:40]
    qpath = tmp_path / "q.fasta"
    with open(qpath, "w") as f:
        f.write(">myquery\n" + "".join(ALPHABET[c] for c in qseq) + "\n")

    assert main(["preprocess", "-i", str(db_fasta),
                 "-o", str(tmp_path / "db")]) == 0
    assert main(["search", "-q", str(qpath), "-d", str(tmp_path / "db"),
                 "-r", "5", "--devices", "1"]) == 0
    out = capsys.readouterr().out

    assert "Query description: \t\tmyquery" in out
    assert "Search speed:" in out and "GCUPS" in out
    # parse the top-5 table: lines "score\ttitle"
    rows = re.findall(r"^(\d+)\tdbseq(\d+) ", out, re.M)
    assert len(rows) == 5
    sm = get_submat("blosum62")
    want = sorted((sw_score_numpy(qseq, s, sm) for s in seqs),
                  reverse=True)[:5]
    assert [int(r[0]) for r in rows] == want
    # the query is a prefix of dbseq7, so dbseq7 must be the top hit
    assert rows[0][1] == "7"

    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "Devices" in out


def test_cli_search_distributed(tmp_path, fasta_db, rng, capsys):
    db_fasta, seqs = fasta_db
    qpath = tmp_path / "q.fasta"
    with open(qpath, "w") as f:
        f.write(">q0\n" + "".join(ALPHABET[c] for c in seqs[3][:30]) + "\n")
    assert main(["preprocess", "-i", str(db_fasta),
                 "-o", str(tmp_path / "db")]) == 0
    assert main(["search", "-q", str(qpath), "-d", str(tmp_path / "db"),
                 "-r", "3", "--devices", "8"]) == 0
    out = capsys.readouterr().out
    rows = re.findall(r"^(\d+)\tdbseq(\d+) ", out, re.M)
    assert len(rows) == 3
    sm = get_submat("blosum62")
    want = sorted((sw_score_numpy(seqs[3][:30], s, sm) for s in seqs),
                  reverse=True)[:3]
    assert [int(r[0]) for r in rows] == want


def test_cli_error_handling(tmp_path, capsys):
    assert main(["search", "-q", "nope.fasta", "-d", "nope"]) == 2
    err = capsys.readouterr().err
    assert "error:" in err


def test_cli_bad_matrix(tmp_path, fasta_db, capsys):
    db_fasta, seqs = fasta_db
    qpath = tmp_path / "q.fasta"
    with open(qpath, "w") as f:
        f.write(">q\nMKTA\n")
    assert main(["preprocess", "-i", str(db_fasta),
                 "-o", str(tmp_path / "db")]) == 0
    assert main(["search", "-q", str(qpath), "-d", str(tmp_path / "db"),
                 "-s", "nosuchmatrix"]) == 2
    assert "unknown substitution matrix" in capsys.readouterr().err


def test_cli_json_output(tmp_path, fasta_db, capsys):
    import json
    db_fasta, seqs = fasta_db
    qpath = tmp_path / "q.fasta"
    with open(qpath, "w") as f:
        f.write(">jq\n" + "".join(ALPHABET[c] for c in seqs[2][:25]) + "\n")
    assert main(["preprocess", "-i", str(db_fasta),
                 "-o", str(tmp_path / "db")]) == 0
    assert main(["search", "-q", str(qpath), "-d", str(tmp_path / "db"),
                 "-r", "3", "--json", "--devices", "1"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    objs = [json.loads(l) for l in lines]
    qobj = next(o for o in objs if "hits" in o)
    assert qobj["query"] == "jq" and len(qobj["hits"]) == 3
    sm = get_submat("blosum62")
    want = sorted((sw_score_numpy(seqs[2][:25], s, sm) for s in seqs),
                  reverse=True)[:3]
    assert [h["score"] for h in qobj["hits"]] == want
    summary = next(o for o in objs if "summary" in o)
    assert summary["summary"]["n_queries"] == 1


def test_cli_align_output(tmp_path, fasta_db, capsys):
    """--align prints a traceback block per hit whose rescored alignment
    matches the reported score (text mode) and ships coordinates+rows in
    --json mode."""
    import json
    db_fasta, seqs = fasta_db
    qseq = seqs[11][:30]
    qpath = tmp_path / "q.fasta"
    with open(qpath, "w") as f:
        f.write(">aq\n" + "".join(ALPHABET[c] for c in qseq) + "\n")
    assert main(["preprocess", "-i", str(db_fasta),
                 "-o", str(tmp_path / "db")]) == 0
    assert main(["search", "-q", str(qpath), "-d", str(tmp_path / "db"),
                 "-r", "3", "--align", "--devices", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("Identities:") == 3
    assert "Query" in out and "Sbjct" in out
    # the self-hit aligns gap-free end to end
    assert f"> dbseq11" in out

    assert main(["search", "-q", str(qpath), "-d", str(tmp_path / "db"),
                 "-r", "2", "--align", "--json", "--devices", "1"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    qobj = next(json.loads(l) for l in lines if "hits" in l)
    top = qobj["hits"][0]
    assert top["alignment"]["identities"] == 30
    assert top["alignment"]["q_aln"] == top["alignment"]["s_aln"]
    assert top["alignment"]["q_start"] == 1


def test_cli_align_distributed(tmp_path, fasta_db, capsys):
    """--align + --devices 8: the dist engine's align post-pass works
    through the CLI and traceback scores match the reported scores."""
    db_fasta, seqs = fasta_db
    qpath = tmp_path / "q.fasta"
    with open(qpath, "w") as f:
        f.write(">dq\n" + "".join(ALPHABET[c] for c in seqs[5][:20]) + "\n")
    assert main(["preprocess", "-i", str(db_fasta),
                 "-o", str(tmp_path / "db")]) == 0
    assert main(["search", "-q", str(qpath), "-d", str(tmp_path / "db"),
                 "-r", "2", "--align", "--devices", "8"]) == 0
    out = capsys.readouterr().out
    assert out.count("Identities:") == 2
    assert "> dbseq5" in out


def test_cli_tabular_output(tmp_path, rng, capsys):
    """--tab prints BLAST outfmt-6 lines whose fields are self-consistent
    with the alignment and the search scores."""
    seqs = [random_protein(rng, int(l))
            for l in rng.integers(30, 150, size=120)]
    with open(tmp_path / "db.fasta", "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">tseq{i} desc\n" + "".join(ALPHABET[c] for c in s)
                    + "\n")
    qseq = seqs[9][:50]
    with open(tmp_path / "q.fasta", "w") as f:
        f.write(">tq some query\n" + "".join(ALPHABET[c] for c in qseq)
                + "\n")
    assert main(["preprocess", "-i", str(tmp_path / "db.fasta"),
                 "-o", str(tmp_path / "db")]) == 0
    assert main(["search", "-q", str(tmp_path / "q.fasta"),
                 "-d", str(tmp_path / "db"), "-r", "4", "--tab",
                 "--devices", "1"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("tq\t")]
    assert len(lines) == 4
    top = lines[0].split("\t")
    assert len(top) == 12
    # self-hit: subject tseq9, 100% identity over 50 columns, full spans
    assert top[1] == "tseq9"
    assert float(top[2]) == 100.0 and int(top[3]) == 50
    assert int(top[4]) == 0 and int(top[5]) == 0           # mism, gapopen
    assert (int(top[6]), int(top[7])) == (1, 50)           # qstart, qend
    assert int(top[8]) == 1 and int(top[9]) == 50          # sstart, send
    assert float(top[10]) < 1e-6                           # evalue
    assert float(top[11]) > 20                             # bits


def test_tune_autotune_tiny(monkeypatch, capsys):
    """The autotuner's coordinate descent runs end-to-end (tiny axes,
    interpret kernel, asked for explicitly), disqualifies nothing on a
    healthy device, and returns a valid geometry whose checksum gate
    held; without a GPU and without that request it refuses to run."""
    import oswald_tpu.tune as tune
    monkeypatch.setattr(tune, "U_ROWS_AXIS", (8,))
    monkeypatch.setattr(tune, "GROUP_BLOCK_AXIS", (1, 2))
    monkeypatch.setattr(tune, "COL_UNROLL_AXIS", (16,))
    with pytest.raises(RuntimeError, match="needs a GPU"):
        tune.autotune(m=16, groups=2, chunks=1, iters=1)
    out = tune.autotune(m=16, groups=2, chunks=1, iters=1,
                        log=lambda s: None, interpret=True)
    assert out["u_rows"] == 8 and out["col_unroll"] == 16
    assert out["group_block"] in (1, 2)
    assert out["gcells"] > 0
    assert all("error" not in r for r in out["results"]), out["results"]
    # CLI wiring
    from oswald_tpu.cli.main import build_parser
    args = build_parser().parse_args(["tune", "--m", "16", "--iters", "1"])
    assert args.op == "tune" and args.m == 16


def test_cli_col_unroll_flag(tmp_path):
    """--col-unroll reaches SearchConfig (and validates)."""
    from oswald_tpu.cli.main import build_parser
    args = build_parser().parse_args(
        ["search", "-q", "q.fa", "-d", "db", "--col-unroll", "8"])
    assert args.col_unroll == 8


def test_cli_cache_pack_unpack(tmp_path, capsys):
    """`cache pack` archives a cache dir into one tarball and `cache
    unpack` pre-seeds a fresh directory from it (the shippable-
    precompiled-binary story, utils.c:144-150); existing entries are
    kept unless --overwrite."""
    from oswald_tpu.cli.main import main as cli_main
    src = tmp_path / "cache"
    (src / "sub").mkdir(parents=True)
    (src / "a.bin").write_bytes(b"AAAA")
    (src / "sub" / "b.bin").write_bytes(b"BB")
    tar = str(tmp_path / "warm.tar.gz")
    assert cli_main(["cache", "pack", tar,
                     "--compile-cache", str(src)]) == 0
    out = capsys.readouterr().out
    assert "packed 2 compiled programs" in out

    dst = tmp_path / "fresh"
    assert cli_main(["cache", "unpack", tar,
                     "--compile-cache", str(dst)]) == 0
    assert (dst / "a.bin").read_bytes() == b"AAAA"
    assert (dst / "sub" / "b.bin").read_bytes() == b"BB"
    assert "unpacked 2 programs" in capsys.readouterr().out
    # second unpack: everything already present
    assert cli_main(["cache", "unpack", tar,
                     "--compile-cache", str(dst)]) == 0
    assert "(2 already present)" in capsys.readouterr().out
    # info
    assert cli_main(["cache", "info",
                     "--compile-cache", str(dst)]) == 0
    assert "2 programs" in capsys.readouterr().out
    # user errors: missing tar arg / missing source dir
    assert cli_main(["cache", "pack",
                     "--compile-cache", str(src)]) == 2
    assert cli_main(["cache", "pack", tar,
                     "--compile-cache", str(tmp_path / "nope")]) == 2


def test_cache_unpack_rejects_path_escape(tmp_path):
    """A hostile cache tarball with ../ members must be rejected, not
    written outside the cache dir."""
    import tarfile
    import io as _io
    import pytest
    from oswald_tpu.utils.compile_cache import unpack_cache
    tar = tmp_path / "evil.tar.gz"
    with tarfile.open(tar, "w:gz") as tf:
        data = b"pwned"
        info = tarfile.TarInfo("../escape.bin")
        info.size = len(data)
        tf.addfile(info, _io.BytesIO(data))
    with pytest.raises(ValueError, match="unsafe path"):
        unpack_cache(str(tar), str(tmp_path / "cache"))
    assert not (tmp_path / "escape.bin").exists()
