"""The port's data layer (`ealdm_torch/data/`, `utils/png.py`'s reader)
against the JAX package's (`ealdm_tpu/data/`), pandas and PIL, on the CPU:

- the synthetic corpus is byte for byte JAX's for the same seed;
- `StreamCameraDataset` equals JAX's for every phase and mask_frac 0 and
  0.3: len, boundaries, the four scaler JSON files byte for byte, and every
  item (the other-site `img_random` draws included), under two time zones
  (the ETL reads naive timestamps in the host's zone, as JAX's
  `datetime.timestamp` over pandas does);
- the pandas steps it replaces: `read_csv`'s types, the inner merge's row
  order with duplicate keys, `half_up_minute` on ties;
- `DataLoader` and `DataModule` give JAX's order over two epochs;
  `DevicePrefetcher` on the CPU keeps the order, hands out tensors with the
  string leaves left on the host, and raises a worker's error;
- the native loader (built from `native/loader.cpp`) equals JAX's native
  path; the PNG reader equals PIL's decode; the numpy BICUBIC and BILINEAR
  resize equals Pillow's; `ImageFolderDataset`'s items equal JAX's within
  1/255, at a size that resizes and one that does not.
"""
import io
import os
import pathlib
import time

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from ealdm_torch.data import images as t_images
from ealdm_torch.data import native_loader as t_native
from ealdm_torch.data import pipeline as t_pipeline
from ealdm_torch.data import stdiff as t_stdiff
from ealdm_torch.data import synthetic as t_synthetic
from ealdm_torch.utils.png import decode_png, encode_png, load_png, to_rgb
from ealdm_tpu.data import images as j_images
from ealdm_tpu.data import native_loader as j_native
from ealdm_tpu.data import pipeline as j_pipeline
from ealdm_tpu.data import stdiff as j_stdiff
from ealdm_tpu.data import synthetic as j_synthetic

SITES = ("Site_A_01", "Avery Brook_Bridge_01171000", "Site_C_03")
SIDE = 16


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    a, b = root / "jax", root / "port"
    j_synthetic.generate_synthetic_dataset(str(a), sites=SITES, n_days=30, image_size=SIDE,
                                           seed=3)
    t_synthetic.generate_synthetic_dataset(str(b), sites=SITES, n_days=30, image_size=SIDE,
                                           seed=3)
    return root, a, b


def test_synthetic_corpus_is_byte_equal(corpus):
    _, a, b = corpus
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    files_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files_a == files_b and len(files_a) == 3 * (30 + 3) + 2
    for rel in files_a:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def _same_tree(x, y, path=""):
    if isinstance(x, dict):
        assert list(x) == list(y), path
        for k in x:
            _same_tree(x[k], y[k], f"{path}.{k}")
    else:
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=path)


def _compare(root, a, phase, mask_frac, tag):
    sa, sb = root / f"scalers_jax_{tag}", root / f"scalers_port_{tag}"
    want = j_stdiff.StreamCameraDataset(str(a), str(a), phase=phase, image_size=SIDE,
                                        mask_frac=mask_frac, path_scaler=str(sa))
    got = t_stdiff.StreamCameraDataset(str(a), str(a), phase=phase, image_size=SIDE,
                                       mask_frac=mask_frac, path_scaler=str(sb))
    assert len(got) == len(want) > 0
    assert got.boundaries == want.boundaries
    names = sorted(os.listdir(sa))
    assert names == sorted(os.listdir(sb)) and len(names) == 4
    for name in names:
        assert (sa / name).read_bytes() == (sb / name).read_bytes(), name
    np.testing.assert_array_equal(got.dates, want.dates)
    for i in range(len(want)):
        _same_tree(got[i], want[i], f"item {i}")
    return got


@pytest.mark.parametrize("mask_frac", [0.0, 0.3])
@pytest.mark.parametrize("phase", ["trainval", "train", "val", "test", "all", "pretrain"])
def test_stream_camera_dataset_equals_jax(corpus, phase, mask_frac):
    root, a, _ = corpus
    _compare(root, a, phase, mask_frac, f"{phase}_{mask_frac}")


@pytest.fixture
def time_zone(request, monkeypatch):
    monkeypatch.setenv("TZ", request.param)
    time.tzset()
    yield request.param
    monkeypatch.undo()
    time.tzset()


@pytest.mark.parametrize("time_zone", ["UTC", "America/New_York"], indirect=True)
def test_stream_camera_dataset_equals_jax_in_two_time_zones(corpus, time_zone):
    root, a, _ = corpus
    got = _compare(root, a, "all", 0.0, f"tz_{time_zone.replace('/', '_')}")
    # the capture times are read in the zone: the first frame of the first site
    first = got.timetransformer.inverse_transform(got.dates[0].reshape(1, -1))[0, 0]
    stamp = pd.read_csv(a / sorted(SITES)[0] / "images.csv")["timestamp"][0]
    assert first == pd.Timestamp(stamp).tz_localize(time_zone).timestamp()


def test_read_csv_types_as_pandas(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("i,f,s,d,m,b\n1,1.5,x,2021-03-01 12:15:00,3,True\n"
                    "2,,NA,2021-03-02 09:00:00,,False\n-7,2e3,z,2021-03-03 00:00:00,4,True\n")
    got = t_stdiff.read_csv(str(path), parse_dates=["d"])
    want = pd.read_csv(path, parse_dates=["d"])
    assert [list(r) for r in got] == [list(want.columns)] * 3
    for col in want.columns:
        for r, w in zip(got, want[col].tolist()):
            v = r[col]
            if isinstance(w, float) and np.isnan(w):
                assert isinstance(v, float) and np.isnan(v), col
            elif col == "d":
                assert pd.Timestamp(v) == w
            else:
                assert v == w and type(v) is type(w.item() if hasattr(w, "item") else w), col


def test_inner_merge_keeps_pandas_row_order():
    left = [{"k": k, "a": i, "c": 10 * i} for i, k in enumerate([3, 1, 3, 2, 1])]
    right = [{"k": k, "b": i, "c": -i} for i, k in enumerate([1, 3, 1, 9, 3])]
    got = t_stdiff.inner_merge(left, right, ["k"])
    want = pd.DataFrame(left).merge(pd.DataFrame(right), on=["k"])
    assert [list(r) for r in got] == [list(want.columns)] * len(want)
    assert [list(r.values()) for r in got] == want.values.tolist()


def test_half_up_minute_equals_jax_on_ties():
    rng = np.random.RandomState(0)
    stamps = ["2021-03-01 12:07:30", "2021-03-01 12:22:30", "2021-03-01 12:37:30",
              "2021-03-01 12:07:29", "2021-03-01 12:07:31", "2021-03-01 23:52:30"]
    stamps += [str(pd.Timestamp("2021-01-01") + pd.Timedelta(seconds=int(s)))
               for s in rng.randint(0, 365 * 86400, 200)]
    for s in stamps:
        want = j_stdiff.half_up_minute(pd.Timestamp(s))
        got = t_stdiff.half_up_minute(t_stdiff._parse_datetime(s))
        assert pd.Timestamp(got) == want, s


@pytest.mark.parametrize("shuffle", [False, True])
def test_data_loader_order_equals_jax(shuffle):
    data = [{"x": np.array([i], np.float32), "s": f"item{i}"} for i in range(23)]
    for drop_last in (True, False):
        tl = t_pipeline.DataLoader(t_pipeline.WrappedDataset(data), 4, shuffle=shuffle,
                                   drop_last=drop_last, seed=5)
        jl = j_pipeline.DataLoader(j_pipeline.WrappedDataset(data), 4, shuffle=shuffle,
                                   drop_last=drop_last, seed=5)
        assert len(tl) == len(jl)
        for epoch in range(2):
            tl.set_epoch(epoch)
            jl.set_epoch(epoch)
            got, want = list(tl), list(jl)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g["x"], w["x"])
                np.testing.assert_array_equal(g["s"], w["s"])


def test_data_module_order_equals_jax(corpus):
    root, a, _ = corpus
    cfg = {"target": "STDiff.dataset_wlbl.ImageNetVidDataset",
           "params": {"path": str(a), "path_weather": str(a), "image_size": SIDE,
                      "path_scaler": str(root / "dm_scalers")}}
    val = dict(cfg, params=dict(cfg["params"], phase="test"))
    tm = t_pipeline.DataModule(3, {"train": cfg, "validation": val}, wrap=True, seed=9)
    jm = j_pipeline.DataModule(3, {"train": cfg, "validation": val}, wrap=True, seed=9)
    for loaders in ((tm.train_dataloader(), jm.train_dataloader()),
                    (tm.val_dataloader(), jm.val_dataloader())):
        for epoch in range(2):
            for loader in loaders:
                loader.set_epoch(epoch)
            got, want = list(loaders[0]), list(loaders[1])
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                _same_tree(g, w)
    assert tm.test_dataloader() is None and jm.test_dataloader() is None


def test_device_prefetcher_keeps_order_and_raises():
    class Boom(t_pipeline.Dataset):
        def __len__(self):
            return 10

        def __getitem__(self, i):
            if i == 7:
                raise KeyError("bad item 7")
            return {"x": np.full((2,), i, np.int64), "name": f"n{i}"}

    loader = t_pipeline.DataLoader(Boom(), 2)
    seen = []
    with pytest.raises(KeyError, match="bad item 7"):
        for batch in t_pipeline.DevicePrefetcher(loader, device="cpu"):
            assert isinstance(batch["x"], torch.Tensor) and batch["x"].device.type == "cpu"
            assert isinstance(batch["name"], np.ndarray) and batch["name"].dtype.kind == "U"
            seen.append(batch["x"][:, 0].tolist())
    assert seen == [[0, 1], [2, 3], [4, 5]]
    # a caller that stops early releases the worker
    ok = t_pipeline.DataLoader(t_pipeline.WrappedDataset(
        [{"x": np.array([i])} for i in range(50)]), 1)
    for i, batch in enumerate(t_pipeline.DevicePrefetcher(ok, device="cpu")):
        assert batch["x"].item() == i
        if i == 3:
            break


def test_native_loader_equals_jax_native_path(tmp_path):
    rng = np.random.RandomState(1)
    paths = []
    for i, (shape, dtype) in enumerate([((16, 16, 3), np.uint8), ((20, 12, 3), np.uint8),
                                         ((9, 9), np.uint8), ((16, 16, 3), np.float32),
                                         ((10, 14, 4), np.uint8)]):
        arr = rng.rand(*shape) * (255 if dtype == np.uint8 or i == 3 else 1)
        p = str(tmp_path / f"{i}.npy")
        np.save(p, arr.astype(dtype))
        paths.append(p)
    assert j_native.native_available()  # the JAX package's native path
    assert t_native.library_path().startswith(t_native.BUILD_DIR)
    for size in (8, 16, 24):
        for p in paths:
            np.testing.assert_array_equal(t_native.load_image(p, size),
                                          j_native.load_image(p, size))
        np.testing.assert_array_equal(t_native.load_batch(paths, size, threads=2),
                                      j_native.load_batch(paths, size, threads=2))
    assert t_native.probe(paths[1]) == (20, 12, 3)
    with pytest.raises(ValueError, match="failed"):
        bad = tmp_path / "bad.npy"
        bad.write_bytes(b"not an npy file")
        t_native.load_image(str(bad), 8)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_reader_equals_pil(mode):
    rng = np.random.RandomState(2)
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    shape = (37, 29) if c == 1 else (37, 29, c)
    # smooth rows so PIL's encoder picks every row filter
    arr = (np.cumsum(rng.randint(0, 5, shape), axis=0) + rng.randint(0, 3, shape)).astype(
        np.uint8)
    for options in ({}, {"optimize": True}, {"compress_level": 0}):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, "PNG", **options)
        got = decode_png(buf.getvalue())
        img = Image.open(io.BytesIO(buf.getvalue()))
        np.testing.assert_array_equal(got, np.asarray(img))
        np.testing.assert_array_equal(to_rgb(got), np.asarray(img.convert("RGB")))
    for name in ("example_conditioning/superresolution/sample_0.png",
                 "inpainting_examples/example0_mask.png"):
        path = pathlib.Path(__file__).resolve().parents[1] / "data" / name
        np.testing.assert_array_equal(load_png(str(path)), np.asarray(Image.open(path)))
    grid = rng.randint(0, 256, (9, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(grid)), grid)


@pytest.mark.parametrize("kind", ["bicubic", "bilinear"])
def test_resample_equals_pillow(kind):
    rng = np.random.RandomState(4)
    pil = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}[kind]
    for (h, w), (oh, ow) in [((64, 64), (32, 32)), ((40, 30), (64, 64)), ((37, 91), (64, 17)),
                             ((96, 96), (96, 96))]:
        a = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = np.asarray(Image.fromarray(a).resize((ow, oh), pil))
        np.testing.assert_array_equal(t_images.resample(a, (ow, oh), kind), want)
        g = a[..., 0]
        np.testing.assert_array_equal(t_images.resample(g, (ow, oh), kind),
                                      np.asarray(Image.fromarray(g).resize((ow, oh), pil)))


@pytest.mark.parametrize("size", [24, 32])
def test_image_folder_dataset_equals_jax(tmp_path, size):
    rng = np.random.RandomState(5)
    for i, shape in enumerate([(32, 32, 3), (40, 32, 3), (32, 48)]):
        arr = rng.randint(0, 256, shape).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / f"img{i}.png")
    np.save(tmp_path / "img3.npy", rng.rand(32, 32, 3).astype(np.float32))
    (tmp_path / "list.txt").write_text("img1.png\nimg3.npy\n")
    for txt in (None, str(tmp_path / "list.txt")):
        got = t_images.ImageFolderDataset(str(tmp_path), txt_file=txt, size=size, flip_p=0.5,
                                          seed=3)
        want = j_images.ImageFolderDataset(str(tmp_path), txt_file=txt, size=size, flip_p=0.5,
                                           seed=3)
        assert got.paths == want.paths and len(got) == len(want)
        for i in range(len(want)):
            g, w = got[i], want[i]
            assert g["file_path_"] == w["file_path_"]
            assert g["image"].shape == w["image"].shape == (size, size, 3)
            np.testing.assert_allclose(g["image"], w["image"], rtol=0, atol=1 / 255)
    jpg = tmp_path / "x.jpg"
    jpg.write_bytes(b"")
    ds = t_images.ImageFolderDataset(str(tmp_path), size=size)
    with pytest.raises(NotImplementedError, match="item 9"):
        ds[ds.paths.index(str(jpg))]


def test_unported_readers_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="item 6"):
        t_stdiff.load_data_from_h5(str(tmp_path / "x.h5"))
    w = tmp_path / "Weather"
    w.mkdir()
    (w / "a.xlsx").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="item 6"):
        t_stdiff.StreamCameraDataset._load_weather(None, str(tmp_path))
