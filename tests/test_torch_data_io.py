"""ray_tpu_torch.data's datasources and writers against ray_tpu.data's.

Each case writes its input files once under ``tmp_path``, then reads them
(and, for the writers, writes and reads back) with ``ray_tpu.data`` under
``ray_tpu.init`` and with ``ray_tpu_torch.data`` under
``ray_tpu_torch.init``, never nested. The blocks must be equal, in order:
file reads are one task per file in sorted path order and their blocks
keep that order, sharded reads one task per shard in shard order. A
format whose package is missing raises an ImportError naming it.
"""

import io
import json
import sqlite3
import sys
import tarfile

import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as jdata
import ray_tpu_torch
import ray_tpu_torch.data as tdata
from test_torch_data_ops import _norm

SIDES = (("jax", ray_tpu, jdata), ("torch", ray_tpu_torch, tdata))


def run_both(case, tmp_path):
    out = {}
    for side, rt, rd in SIDES:
        rt.shutdown()
        rt.init(num_cpus=8)
        side_dir = tmp_path / f"out_{side}"
        side_dir.mkdir()
        try:
            out[side] = _norm(case(rd, side_dir))
        finally:
            rt.shutdown()
    return out["jax"], out["torch"]


def _blocks(ds):
    return list(ds.iter_batches(batch_size=None))


# -- inputs ---------------------------------------------------------------


def _write_images(d):
    from PIL import Image

    d.mkdir()
    for i in range(4):
        Image.fromarray(np.full((8 + i, 10, 3), i * 20, np.uint8)).save(
            d / f"img{i}.png")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(d / "extra.jpg")


def _write_tfrecords(d):
    from ray_tpu.data.tfrecord import encode_example, write_records

    d.mkdir()
    recs = [encode_example({"label": [i - 2], "weight": [0.5 * i, 1.5],
                            "name": f"row{i}".encode(), "blob": b"ab\x00"})
            for i in range(5)]
    write_records(str(d / "a.tfrecord"), recs[:3])
    write_records(str(d / "b.tfrecord"), recs[3:])


def _write_sqlite(path):
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE items (id INTEGER, name TEXT, score REAL)")
    conn.executemany("INSERT INTO items VALUES (?, ?, ?)",
                     [(i, f"n{i}", i * 0.5) for i in range(20)])
    conn.execute("INSERT INTO items VALUES (NULL, 'nk', 0.25)")
    conn.commit()
    conn.close()


def _write_webdataset(d):
    from PIL import Image

    d.mkdir()

    def add(tf, name, data):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))

    for shard, rng in (("s0.tar", range(3)), ("s1.tar", range(3, 5))):
        with tarfile.open(d / shard, "w") as tf:
            for i in rng:
                add(tf, f"sample{i:04d}.caption.txt", f"caption {i}".encode())
                add(tf, f"sample{i:04d}.cls", str(i % 2).encode())
                add(tf, f"sample{i:04d}.json", json.dumps({"idx": i}).encode())
    buf = io.BytesIO()
    Image.fromarray(np.full((4, 6, 3), 7, np.uint8)).save(buf, format="PNG")
    with tarfile.open(d / "s2.tar", "w") as tf:
        add(tf, "train/0001.txt", b"train one")
        add(tf, "val/0001.txt", b"val one")
    with tarfile.open(d / "img.tar", "w") as tf:
        add(tf, "a.png", buf.getvalue())


def _write_delta(root):
    import pyarrow as pa
    import pyarrow.parquet as pq

    log = root / "_delta_log"
    log.mkdir(parents=True)
    for name, ids in (("f0.parquet", [0, 1]), ("f1.parquet", [2, 3]),
                      ("f2.parquet", [4, 5])):
        pq.write_table(pa.table({"id": pa.array(ids, pa.int64())}),
                       root / name)

    def commit(version, actions):
        with open(log / f"{version:020d}.json", "w") as f:
            for a in actions:
                f.write(json.dumps(a) + "\n")

    commit(0, [{"add": {"path": "f0.parquet",
                        "partitionValues": {"split": "train"}}},
               {"add": {"path": "f1.parquet",
                        "partitionValues": {"split": "val"}}}])
    commit(1, [{"remove": {"path": "f1.parquet"}},
               {"add": {"path": "f2.parquet",
                        "partitionValues": {"split": "val"}}}])


_DOCS = [{"_id": i, "name": f"d{i}", "score": i * 1.5} for i in range(10)]


class _FakeColl:
    def aggregate(self, stages):
        out = list(_DOCS)
        for st in stages:
            if "$match" in st:
                flt = st["$match"]
                out = [d for d in out if all(
                    (d.get(k) >= v["$gte"] if "$gte" in v else True)
                    and (d.get(k) < v["$lt"] if "$lt" in v else True)
                    if isinstance(v, dict) else d.get(k) == v
                    for k, v in flt.items())]
            elif "$sort" in st:
                (k, direc), = st["$sort"].items()
                out = sorted(out, key=lambda d: d[k], reverse=direc < 0)
            elif "$skip" in st:
                out = out[st["$skip"]:]
            elif "$limit" in st:
                out = out[:st["$limit"]]
            elif "$count" in st:
                out = [{st["$count"]: len(out)}]
        return iter(out)

    def count_documents(self, flt):
        return len(_DOCS)


class _FakeMongo(dict):
    def __getitem__(self, k):
        return _FakeDB()

    def close(self):
        pass


class _FakeDB(dict):
    def __getitem__(self, k):
        return _FakeColl()


class _FakeBQ:
    rows = {"s0": [{"id": 0, "v": "a"}, {"id": 1, "v": "b"}],
            "s1": [{"id": 2, "v": "c"}],
            "s2": [{"id": 3, "v": "d"}, {"id": 4, "v": "e"}]}

    def create_read_session(self, table, max_streams):
        return list(self.rows)[:max_streams]

    def read_rows(self, stream_id):
        return iter(self.rows[stream_id])


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    _write_images(d / "images")
    _write_tfrecords(d / "tfrec")
    _write_sqlite(str(d / "t.db"))
    _write_webdataset(d / "wds")
    _write_delta(d / "delta")
    (d / "npy").mkdir()
    for i in range(3):
        np.save(d / "npy" / f"a{i}.npy",
                np.arange(6, dtype=np.float32).reshape(3, 2) + i)
    (d / "bin").mkdir()
    for i in range(3):
        (d / "bin" / f"f{i}.bin").write_bytes(bytes(range(i, i + 5)))
    return d


def _sql_factory(path):
    def factory(path=path):
        return sqlite3.connect(path, timeout=30)
    return factory


def _case_sql(rd, out, d):
    f = _sql_factory(str(d / "t.db"))
    plain = _blocks(rd.read_sql("SELECT * FROM items", f))
    sharded = _blocks(rd.read_sql("SELECT * FROM items", f,
                                  shard_column="id", num_shards=4))
    db = str(out / "w.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE high (id INTEGER, name TEXT, score REAL)")
    conn.commit()
    conn.close()
    n = (rd.read_sql("SELECT * FROM items WHERE id IS NOT NULL", f)
         .filter(lambda r: r["score"] >= 5.0)
         .write_sql("INSERT INTO high VALUES (?, ?, ?)", _sql_factory(db)))
    conn = sqlite3.connect(db)
    back = conn.execute("SELECT * FROM high ORDER BY id").fetchall()
    conn.close()
    return plain, sharded, n, back


def _written(rd, out, fmt):
    ds = rd.range(30, parallelism=3).map(
        lambda r: {"id": r["id"], "x": r["id"] * 0.5, "s": f"v{r['id']}"})
    files = getattr(ds, f"write_{fmt}")(str(out / fmt))
    reader = getattr(rd, f"read_{fmt}")
    return ([f.rsplit("/", 1)[-1] for f in files],
            _blocks(reader(str(out / fmt))))


IO_CASES = {
    "parquet": lambda rd, out, d: _written(rd, out, "parquet"),
    "csv": lambda rd, out, d: _written(rd, out, "csv"),
    "json": lambda rd, out, d: _written(rd, out, "json"),
    "numpy": lambda rd, out, d: _blocks(rd.read_numpy(str(d / "npy"))),
    "binary": lambda rd, out, d: [
        {k: (v.tolist() if k != "path" else [p.rsplit("/", 1)[-1]
                                             for p in v])
         for k, v in b.items()}
        for b in _blocks(rd.read_binary_files(str(d / "bin" / "*.bin")))],
    "images": lambda rd, out, d: [
        [[(k, v.shape if k == "image" else v[-8:])
          for k, v in r.items()] for r in rd.read_images(
            str(d / "images")).take_all()],
        _blocks(rd.read_images(str(d / "images"), size=(16, 12)).select_columns(
            ["image"]))],
    "tfrecords": lambda rd, out, d: (
        _blocks(rd.read_tfrecords(str(d / "tfrec"), validate_data_crc=True)),
        _blocks(rd.read_tfrecords(str(d / "tfrec" / "a.tfrecord"),
                                  raw=True))),
    "sql": lambda rd, out, d: _case_sql(rd, out, d),
    "webdataset": lambda rd, out, d: (
        rd.read_webdataset(str(d / "wds" / "s0.tar")).take_all()
        + rd.read_webdataset(str(d / "wds" / "s1.tar")).take_all(),
        [[(k, v.tolist() if isinstance(v, np.ndarray) else v)
          for k, v in r.items()]
         for r in rd.read_webdataset(str(d / "wds" / "s2.tar")).take_all()
         + rd.read_webdataset(str(d / "wds" / "img.tar")).take_all()],
        rd.read_webdataset(str(d / "wds" / "img.tar"),
                           decode_images=False).take_all()),
    "mongo": lambda rd, out, d: (
        _blocks(rd.read_mongo("mongodb://fake", "db", "c",
                              client_factory=_FakeMongo)),
        _blocks(rd.read_mongo("mongodb://fake", "db", "c",
                              client_factory=_FakeMongo, num_shards=3)),
        rd.read_mongo("mongodb://fake", "db", "c",
                      pipeline=[{"$match": {"name": "d7"}}],
                      client_factory=_FakeMongo).take_all()),
    "bigquery": lambda rd, out, d: (
        _blocks(rd.read_bigquery("p.d.t", client_factory=_FakeBQ)),
        _blocks(rd.read_bigquery("p.d.t", client_factory=_FakeBQ,
                                 max_streams=2))),
    "delta": lambda rd, out, d: _blocks(rd.read_delta(str(d / "delta"))),
}


@pytest.mark.parametrize("name", sorted(IO_CASES))
def test_datasource_matches_ray_tpu_data(name, inputs, tmp_path):
    case = IO_CASES[name]
    want, got = run_both(lambda rd, out: case(rd, out, inputs), tmp_path)
    assert got == want


def test_tfrecord_codec_matches():
    from ray_tpu.data import tfrecord as jt
    from ray_tpu_torch.data import tfrecord as tt

    assert tt.crc32c(b"123456789") == 0xE3069283
    feats = {"label": [-3, 7], "w": [0.25, 1.5], "name": b"x\x00"}
    assert tt.encode_example(feats) == jt.encode_example(feats)
    assert _norm(tt.parse_example(jt.encode_example(feats))) == \
        _norm(jt.parse_example(jt.encode_example(feats)))


@pytest.mark.parametrize("module,package,read", [
    ("pyarrow", "pyarrow", lambda rd, d: rd.read_parquet(str(d))),
    ("pandas", "pandas", lambda rd, d: rd.read_csv(str(d))),
    ("PIL", "Pillow", lambda rd, d: rd.read_images(str(d))),
])
def test_a_missing_package_raises_naming_it(module, package, read,
                                            tmp_path, monkeypatch):
    for name in list(sys.modules):
        if name == module or name.startswith(module + "."):
            monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, module, None)
    (tmp_path / "f.parquet").write_bytes(b"x")
    (tmp_path / "f.csv").write_text("a\n1\n")
    (tmp_path / "f.png").write_bytes(b"x")
    from ray_tpu_torch.data.block import require

    with pytest.raises(ImportError, match=package):
        require(f"{module}.x" if module == "PIL" else module, package)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        with pytest.raises(Exception, match=package):
            read(tdata, tmp_path).take_all()
    finally:
        ray_tpu_torch.shutdown()
