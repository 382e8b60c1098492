"""The FPE-westbrook stream-camera dataset (counterpart of
`ealdm_tpu/data/stdiff.py`), without pandas (the card's machine has none).

Each site's images.csv and values.csv are joined on station and timestamp
(rounded to the 15-minute grid), one frame a day is kept (the earliest
daytime one, 9 < hour < 18, else the earliest), the daily weather files
and the GPT weather labels are joined on the date, and the frames are cut
into non-overlapping (l_seq + 1)-frame windows split by phase. The
scalers are fit on the phase's windows and written as JSON.

Where the JAX package uses pandas, this module does the same steps on
lists of row dicts, in pandas' order:
  * `read_csv`: a column of integers reads as int (as float with NaN if a
    field is missing), of numbers as float, else as str; pandas' default
    NA strings read as missing; `parse_dates` columns as datetimes
    (`datetime.fromisoformat`);
  * `inner_merge`: every left row in order, followed by its matches in the
    right table's order (pandas' inner merge); shared columns that are not
    keys get the suffixes _x and _y;
  * the one-frame-a-day rule: a stable sort on (date, night, timestamp),
    then the first row of each date;
  * the final sort by timestamp is numpy's quicksort of the datetime64
    values (pandas' `sort_values` on one column);
  * `datetime.timestamp` on naive datetimes reads them in the host's local
    time zone, as the JAX package's `map(datetime.timestamp)` does on
    pandas' naive timestamps.
`.xlsx` weather files and `load_data_from_h5` have no reader on the card:
they raise NotImplementedError.
"""
from __future__ import annotations

import csv
import glob
import json
import math
import os
import re
from datetime import datetime, timedelta, timezone
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .pipeline import Dataset
from .scalers import MinMaxScaler, MultiLabelBinarizer, StandardScaler, save_scaler

WEATHER_CLASSES = [
    "Sunny/Clear", "Cloudy/Overcast", "Rainy", "Snowy", "Foggy/Misty",
    "Windy", "Stormy/Severe", "Hot/Heatwave", "Cold/Cold Wave",
    "Mixed/Variable",
]

# the 16-feature daily weather vector (order matters for parity)
WEATHER_COLUMNS = [
    "TIMESTAMP", "Average Temp", "Max Daily Temp", "Time of Daily Temp Max",
    "Min Temp", "Time of Min. Temp", "Wind Speed", "Wind Direction",
    "Max Wind Spd", "Time of Max Wind Spd", "Minimum Wind Spd",
    "Time of Min. Wind Spd.", "Mean Relative Humidity",
    "Atmospheric Pressure", "Mean Solar Radiation", "Total Rainfall",
]

DEFAULT_TEST_SITES = ("Avery Brook_Bridge_01171000",)

_READERS_ITEM = "ROADMAP queue 1 item 6 (the .xlsx and h5 readers)"
# pandas' default NA strings (`read_csv` na_values)
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_INT = re.compile(r"^[+-]?[0-9]+$")
_TIME_COLS = ["Time of Daily Temp Max", "Time of Min. Temp", "Time of Max Wind Spd",
              "Time of Min. Wind Spd."]


def _isna(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _parse_datetime(s: str) -> datetime:
    try:
        return datetime.fromisoformat(s.strip())
    except ValueError as e:
        raise ValueError(f"{s!r}: the port reads ISO 8601 dates and times only") from e


def _column(values: List[str], dates: bool) -> list:
    """A CSV column's fields as pandas' `read_csv` types them."""
    present = [v for v in values if v not in _NA]
    if dates:
        return [None if v in _NA else _parse_datetime(v) for v in values]
    if present and all(_INT.match(v) for v in present):
        if len(present) == len(values):
            return [int(v) for v in values]
        return [float("nan") if v in _NA else float(int(v)) for v in values]
    try:
        return [float("nan") if v in _NA else float(v) for v in values]
    except ValueError:
        pass
    if present and all(v in ("True", "TRUE", "true", "False", "FALSE", "false")
                       for v in present) and len(present) == len(values):
        return [v.lower() == "true" for v in values]
    return [float("nan") if v in _NA else v for v in values]


def read_csv(path: str, parse_dates: Sequence[str] = ()) -> List[Dict]:
    """The rows of a CSV file with a header, as dicts (see the module's
    docstring for the types)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    cols = {}
    for j, name in enumerate(header):
        fields = [r[j] if j < len(r) else "" for r in body]
        cols[name] = _column(fields, name in parse_dates)
    return [{name: cols[name][i] for name in header} for i in range(len(body))]


def inner_merge(left: List[Dict], right: List[Dict], on: Sequence[str]) -> List[Dict]:
    """pandas' `left.merge(right, on=on)` (inner): each left row, in order,
    joined with every right row of equal keys, in the right table's order."""
    index: Dict[tuple, List[Dict]] = {}
    for r in right:
        index.setdefault(tuple(r[k] for k in on), []).append(r)
    lcols = list(left[0]) if left else []
    rcols = list(right[0]) if right else []
    shared = (set(lcols) & set(rcols)) - set(on)
    out = []
    for lrow in left:
        for rrow in index.get(tuple(lrow[k] for k in on), ()):
            row = {}
            for c in lcols:
                row[c + "_x" if c in shared else c] = lrow[c]
            for c in rcols:
                if c not in on:
                    row[c + "_y" if c in shared else c] = rrow[c]
            out.append(row)
    return out


def _drop_duplicates(rows: List[Dict], key: str) -> List[Dict]:
    seen, out = set(), []
    for r in rows:
        if r[key] not in seen:
            seen.add(r[key])
            out.append(r)
    return out


def _datetime64(ts: datetime) -> np.datetime64:
    if ts.tzinfo is not None:  # pandas sorts aware times as UTC instants
        ts = ts.astimezone(timezone.utc).replace(tzinfo=None)
    return np.datetime64(ts, "us")


def half_up_minute(ts: datetime, minutes: int = 15) -> datetime:
    """`ts` on the 15-minute grid: Python's round (half to even) of the
    microseconds since 1970-01-01 over the grid step, as the JAX package's
    pandas arithmetic (microsecond timestamps) gives it."""
    delta = timedelta(minutes=minutes)
    ref = datetime(1970, 1, 1, tzinfo=ts.tzinfo)
    us = (ts - ref) // timedelta(microseconds=1)
    return ref + round(us / (delta // timedelta(microseconds=1))) * delta


def load_data_from_h5(h5_path: str):
    raise NotImplementedError(f"{h5_path}: HDF5 capture files need h5py, which the card's "
                              f"machine does not have ({_READERS_ITEM})")


def parse_response_jsonl(path: str) -> List[Tuple[str, List[str]]]:
    """The GPT label response file as [(date 'YYYY-MM-DD', labels)]: the
    reference's [request, response] lines (the content parsed from its first
    '{'), or plain {"date", "labels"} lines."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if isinstance(obj, dict) and "date" in obj:
                out.append((obj["date"][:10], list(obj.get("labels", []))))
                continue
            req, resp = obj[0], obj[1]
            content = req["messages"][1]["content"]
            payload = json.loads(content[content.index("{"):])
            ts = payload["Timestamp"]
            answer = json.loads(resp["choices"][0]["message"]["content"])
            labels = answer.get("Weather Classified Categories", [])
            out.append((str(ts)[:10], list(labels)))
    return out


def _load_image(path: str, image_size: int) -> np.ndarray:
    """An .npy (the native loader: bilinear with the corners aligned) or PNG
    image -> [H, W, 3] float32 in [-1, 1] at image_size. The native loader
    raises where it fails: the JAX package's numpy and PIL fallback resizes
    differently."""
    if path.endswith(".npy"):
        from . import native_loader

        return native_loader.load_image(path, image_size)
    from .images import read_image, resample

    arr = read_image(path).astype(np.float32) / 255.0
    if arr.shape[0] != image_size or arr.shape[1] != image_size:
        u8 = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        arr = resample(u8, (image_size, image_size), "bilinear").astype(np.float32) / 255.0
    return arr * 2.0 - 1.0


class StreamCameraDataset(Dataset):
    """Environment-aware stream-camera dataset (the weather-label variant).

    Items (l_seq == 1): {"img": [H, W, 3] the next frame in [-1, 1],
    "mixed": {"img" the previous frame, "flow" [1, 1], "weather" [1, 16],
    "time" [1], "label_nxt" [1], "wlabel_nxt" [10], "ids_nxt" [1, 1],
    "img_random": the next frame of a window of another site (the
    classifier-free guidance negative)}}."""

    def __init__(self, path: str, path_weather: str, phase: str = "trainval",
                 batch_size: int = 1, len_seq: int = 1, image_size: int = 256,
                 mask_frac: float = 0.0, normalize_flag: bool = True,
                 path_scaler: Optional[str] = None,
                 test_sites: Sequence[str] = DEFAULT_TEST_SITES, seed: int = 42):
        self.phase = phase
        self.len_seq = len_seq
        self.batch_size = batch_size
        self.l_seq = batch_size * len_seq
        self.image_size = image_size
        self.num_classes = len(WEATHER_CLASSES)
        path_scaler = path_scaler or path
        os.makedirs(path_scaler, exist_ok=True)

        site_list = sorted(d for d in os.listdir(path)
                           if os.path.isfile(os.path.join(path, d, "images.csv")))
        suffix = ""
        if phase == "test":
            site_list = [s for s in site_list if s in set(test_sites)] or site_list[:1]
            suffix = "_ar"

        labels = [{"date_tmp": _parse_datetime(d).strftime("%Y-%m-%d"), "weather_label": wl}
                  for d, wl in parse_response_jsonl(os.path.join(path_weather,
                                                                 "response.jsonl"))]
        weather = inner_merge(self._load_weather(path_weather), labels, ["date_tmp"])

        img_paths, flows, dates, weathers, wlabels = [], [], [], [], []
        self.boundaries: List[Tuple[int, int]] = []
        cursor = 0
        for site in site_list:
            site_data = self._load_site(path, site, weather)
            if site_data is None:
                continue
            windows = self._windows(*site_data)
            if windows[0].shape[0] == 0:
                continue
            windows = self._split(windows, phase, mask_frac, seed)
            n = windows[0].shape[0]
            if n == 0:
                continue
            self.boundaries.append((cursor, cursor + n - 1))
            cursor += n
            img_paths.append(windows[0])
            flows.append(windows[1])
            dates.append(windows[2])
            weathers.append(windows[3])
            wlabels.append(windows[4])

        if not img_paths:
            raise ValueError(f"no usable sites under {path}")
        self.images = np.concatenate(img_paths, axis=0)
        self.flows = np.concatenate(flows, axis=0).astype(np.float64)
        self.dates = np.concatenate(dates, axis=0).astype(np.float64)
        self.weather = np.concatenate(weathers, axis=0).astype(np.float64)
        self.weather_label = np.concatenate(wlabels, axis=0)

        if normalize_flag:
            n, t = self.flows.shape[:2]
            self.normalizer = StandardScaler()
            self.flows = self.normalizer.fit_transform(
                self.flows.reshape(n * t, -1)).reshape(n, t, -1)
            save_scaler(self.normalizer,
                        os.path.join(path_scaler, f"flow_scaler_{phase}{suffix}.json"))
            self.wnormalizer = StandardScaler()
            self.weather = self.wnormalizer.fit_transform(
                self.weather.reshape(n * t, -1)).reshape(n, t, -1)
            save_scaler(self.wnormalizer,
                        os.path.join(path_scaler, f"weather_scaler_{phase}{suffix}.json"))
            self.timetransformer = MinMaxScaler()
            self.dates = self.timetransformer.fit_transform(
                self.dates.reshape(n * t, -1)).reshape(n, t, -1)
            save_scaler(self.timetransformer,
                        os.path.join(path_scaler, f"time_scaler_{phase}{suffix}.json"))
            self.wbinarizer = MultiLabelBinarizer(WEATHER_CLASSES)
            flat = [row for win in self.weather_label for row in win]
            wl = self.wbinarizer.transform(flat)
            self.weather_label = wl.reshape(n, t, -1)
            save_scaler(self.wbinarizer,
                        os.path.join(path_scaler, f"weatherlabel_scaler_{phase}{suffix}.json"))
        self._rng = np.random.RandomState(seed)

    # ------------------------------------------------------------------ ETL
    def _load_weather(self, path_weather: str) -> List[Dict]:
        files = sorted(glob.glob(os.path.join(path_weather, "Weather", "*.csv"))
                       + glob.glob(os.path.join(path_weather, "Weather", "*.xlsx")))
        if not files:
            raise FileNotFoundError(f"no weather files under {path_weather}/Weather")
        rows = []
        for fpath in files:
            if fpath.endswith(".xlsx"):
                raise NotImplementedError(f"{fpath}: .xlsx weather files need a reader the "
                                          f"card's machine does not have ({_READERS_ITEM})")
            table = read_csv(fpath, parse_dates=["TIMESTAMP"] + _TIME_COLS)
            table = [r for r in table if not any(_isna(v) for v in r.values())]  # dropna
            for r in table:
                for c in _TIME_COLS:
                    r[c] = datetime.timestamp(r[c])
            rows.extend(table)
        for r in rows:
            r["date_tmp"] = r["TIMESTAMP"].strftime("%Y-%m-%d")
            r["TIMESTAMP"] = datetime.timestamp(r["TIMESTAMP"])
        return _drop_duplicates(rows, "date_tmp")

    def _load_site(self, path: str, site: str, weather: List[Dict]):
        site_dir = os.path.join(path, site)
        images = read_csv(os.path.join(site_dir, "images.csv"), parse_dates=["timestamp"])
        values = read_csv(os.path.join(site_dir, "values.csv"), parse_dates=["timestamp"])
        for table in (images, values):
            for r in table:
                r["timestamp"] = half_up_minute(r["timestamp"])

        if self.phase == "pretrain":
            vals = np.asarray([r["value"] for r in values], np.float64)
            mean = float(np.nansum(vals) / np.count_nonzero(~np.isnan(vals)))
            data = [dict(r, value=mean) for r in images]
        else:
            data = inner_merge(images, values, ["station_id", "timestamp"])
        if not data:
            return None

        # one frame a day, preferring daytime (9 < hour < 18): a stable sort
        # puts the earliest daytime frame (else the earliest) first in its date
        def order(r):
            ts = r["timestamp"]
            return ts.date(), not (9 < ts.hour < 18), ts

        data = _drop_duplicates(
            [dict(r, _date=order(r)[0]) for r in sorted(data, key=order)], "_date")
        for r in data:
            del r["_date"]
            r["date_tmp"] = r["timestamp"].strftime("%Y-%m-%d")
        data = inner_merge(data, weather, ["date_tmp"])
        if not data:
            return None
        stamps = np.array([_datetime64(r["timestamp"]) for r in data])
        data = [data[i] for i in np.argsort(stamps, kind="quicksort")]

        times = np.array([datetime.timestamp(r["timestamp"]) for r in data])
        img_entries = np.array(
            [[os.path.join(site_dir, "images", f"{r['image_id']}.npy"),
              r.get("url", "") or "", str(r["image_id"])] for r in data],
            dtype=object)
        flows = np.asarray([r["value"] for r in data]).reshape(-1, 1)
        dates = times.reshape(-1, 1)
        weather_arr = np.array([[r[c] for c in WEATHER_COLUMNS] for r in data], np.float64)
        wlabels = np.array(
            [list(v) if not isinstance(v, str) else [v] for v in
             (r["weather_label"] for r in data)], dtype=object)
        return img_entries, flows, dates, weather_arr, wlabels

    def _windows(self, images, flows, dates, weather, wlabels):
        """Non-overlapping windows of length l_seq+1, stride l_seq."""
        step = self.l_seq
        n = images.shape[0]
        idxs = [list(range(i, i + step + 1)) for i in range(0, n - step, step)]
        if not idxs:
            empty = np.zeros((0,))
            return empty, empty, empty, empty, empty
        sel = np.asarray(idxs)
        return (images[sel], flows[sel], dates[sel], weather[sel],
                np.asarray([[wlabels[j] for j in row] for row in sel], dtype=object))

    def _split(self, windows, phase, mask_frac, seed):
        imgs, flows, dates, weather, wlabels = windows
        n = imgs.shape[0]
        rs = np.random.RandomState(seed)
        indices = np.arange(n)
        rs.shuffle(indices)
        train_size = int(0.8 * n)
        val_size = int(0.2 * n)

        def take(sel):
            return tuple(a[sel] for a in (imgs, flows, dates, weather, wlabels))

        if phase in ("trainval", "train"):
            if not mask_frac:
                hi2 = 0.675 if phase == "trainval" else 0.875
                sel = np.concatenate([np.arange(0, round(n * 0.375)),
                                      np.arange(round(n * hi2), n)])
                return take(sel)
            return take(indices[:train_size])
        if phase == "val":
            if not mask_frac:
                return take(np.arange(round(n * 0.675), round(n * 0.875)))
            return take(indices[train_size:train_size + val_size])
        if phase == "test":
            if not mask_frac:
                return take(np.arange(round(n * 0.375), round(n * 0.675)))
            return take(indices[train_size:])
        return windows  # "all" / "pretrain": no split

    # ------------------------------------------------------------- access
    def __len__(self):
        return self.images.shape[0]

    def denormalize(self, pred):
        return self.normalizer.inverse_transform(pred)

    def _other_site_index(self, idx: int) -> int:
        for s, e in self.boundaries:
            if s <= idx <= e:
                pool = np.concatenate([np.arange(0, s), np.arange(e + 1, len(self))])
                if pool.size:
                    return int(self._rng.choice(pool))
                return idx
        return idx

    def _load_window_images(self, idx: int) -> np.ndarray:
        frames = [_load_image(self.images[idx][i][0], self.image_size)
                  for i in range(self.l_seq + 1)]
        return np.stack(frames, axis=0)

    def skip_item(self, idx: int) -> None:
        """What `self[idx]` draws, nothing loaded: a data-parallel rank's
        loader calls it for the other ranks' rows, so the other-site draws
        of its own rows stay those of one process."""
        self._other_site_index(idx)

    def __getitem__(self, idx: int) -> Dict:
        idx_rand = self._other_site_index(idx)
        imgs = self._load_window_images(idx)           # [T+1, H, W, 3]
        imgs_rand = self._load_window_images(idx_rand)

        t = self.dates[idx].astype(np.float32)
        flow = self.flows[idx].astype(np.float32)
        wx = self.weather[idx].astype(np.float32)
        wl = self.weather_label[idx].astype(np.float32)
        ids = np.asarray([[float(self.images[idx][i][2])] for i in range(self.l_seq + 1)],
                         np.float32)
        sample = {
            "img": imgs[1:],
            "mixed": {
                "img": imgs[:-1],
                "flow": flow[:-1].reshape(self.batch_size, self.len_seq, -1),
                "weather": wx[:-1].reshape(self.batch_size, self.len_seq, -1),
                "time": t[1:],
                "label_nxt": flow[1:],
                "wlabel_nxt": wl[1:],
                "ids_nxt": ids[1:],
                "img_random": imgs_rand[1:],
            },
        }
        if self.l_seq == 1:
            sample["img"] = sample["img"][0]
            m = sample["mixed"]
            sample["mixed"] = {
                "img": m["img"][0],
                "flow": m["flow"][0],
                "weather": m["weather"][0],
                "time": m["time"][0],
                "label_nxt": m["label_nxt"][0],
                "wlabel_nxt": m["wlabel_nxt"][0],
                "ids_nxt": m["ids_nxt"],
                "img_random": m["img_random"][0],
            }
        return sample


# the reference's class name
ImageNetVidDataset = StreamCameraDataset
