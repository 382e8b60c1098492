"""Synthetic stream-camera corpus (counterpart of
`ealdm_tpu/data/synthetic.py`; numpy only): the on-disk layout the
stream-camera ETL reads (`data/stdiff.py`): per-site images.csv,
values.csv, station.csv and images/*.npy, the shared Weather/daily.csv and
the GPT response.jsonl in the reference's [request, response] line format.
For the same arguments it writes the same bytes as the JAX package.
"""
from __future__ import annotations

import json
import os
from datetime import datetime, timedelta
from typing import Sequence

import numpy as np

from .stdiff import WEATHER_CLASSES, WEATHER_COLUMNS


def generate_synthetic_site(
    root: str,
    site: str,
    n_days: int = 12,
    image_size: int = 64,
    station_id: int = 1000,
    start: str = "2021-03-01",
    seed: int = 0,
):
    rng = np.random.RandomState(seed)
    site_dir = os.path.join(root, site)
    img_dir = os.path.join(site_dir, "images")
    os.makedirs(img_dir, exist_ok=True)

    t0 = datetime.fromisoformat(start)
    img_rows, val_rows = [], []
    for d in range(n_days):
        ts = t0 + timedelta(days=d, hours=12, minutes=int(rng.randint(0, 4) * 15))
        iid = station_id * 100000 + d
        arr = (rng.rand(image_size, image_size, 3) * 255).astype(np.uint8)
        np.save(os.path.join(img_dir, f"{iid}.npy"), arr)
        stamp = ts.strftime("%Y-%m-%d %H:%M:%S")
        img_rows.append(
            f"{site},{station_id},{iid},{stamp},{iid}.npy,file://{iid}.npy"
        )
        val_rows.append(
            f"{site},{station_id},1,1,FLOW,{stamp},{rng.rand() * 10:.3f}"
        )

    with open(os.path.join(site_dir, "images.csv"), "w") as f:
        f.write("station_name,station_id,image_id,timestamp,filename,url\n")
        f.write("\n".join(img_rows) + "\n")
    with open(os.path.join(site_dir, "values.csv"), "w") as f:
        f.write(
            "station_name,station_id,dataset_id,series_id,variable_id,timestamp,value\n"
        )
        f.write("\n".join(val_rows) + "\n")
    with open(os.path.join(site_dir, "station.csv"), "w") as f:
        f.write("station_id,name,lat,lon\n")
        f.write(f"{station_id},{site},42.4,-72.6\n")


def generate_synthetic_weather(
    root: str, n_days: int = 12, start: str = "2021-03-01", seed: int = 1
):
    rng = np.random.RandomState(seed)
    wdir = os.path.join(root, "Weather")
    os.makedirs(wdir, exist_ok=True)
    t0 = datetime.fromisoformat(start)
    rows = []
    label_lines = []
    for d in range(n_days):
        day = t0 + timedelta(days=d)
        vals = {
            "TIMESTAMP": day.strftime("%Y-%m-%d 00:00:00"),
            "Average Temp": round(10 + 10 * rng.rand(), 2),
            "Max Daily Temp": round(15 + 10 * rng.rand(), 2),
            "Time of Daily Temp Max": (day + timedelta(hours=14)).strftime(
                "%Y-%m-%d %H:%M:%S"
            ),
            "Min Temp": round(rng.rand() * 10, 2),
            "Time of Min. Temp": (day + timedelta(hours=5)).strftime(
                "%Y-%m-%d %H:%M:%S"
            ),
            "Wind Speed": round(rng.rand() * 8, 2),
            "Wind Direction": round(rng.rand() * 360, 1),
            "Max Wind Spd": round(rng.rand() * 15, 2),
            "Time of Max Wind Spd": (day + timedelta(hours=13)).strftime(
                "%Y-%m-%d %H:%M:%S"
            ),
            "Minimum Wind Spd": 0.0,
            "Time of Min. Wind Spd.": (day + timedelta(hours=3)).strftime(
                "%Y-%m-%d %H:%M:%S"
            ),
            "Mean Relative Humidity": round(40 + 50 * rng.rand(), 1),
            "Atmospheric Pressure": round(990 + 40 * rng.rand(), 1),
            "Mean Solar Radiation": round(rng.rand() * 300, 1),
            "Total Rainfall": round(max(0.0, rng.randn()) * 5, 2),
        }
        rows.append(vals)

        labels = [WEATHER_CLASSES[int(rng.randint(0, len(WEATHER_CLASSES)))]]
        user_payload = {
            "Timestamp": day.strftime("%Y-%m-%dT12:00:00Z"),
            "Average Temp": vals["Average Temp"],
        }
        request = {
            "model": "gpt-3.5-turbo-1106",
            "messages": [
                {"role": "system", "content": "weather classifier"},
                {
                    "role": "user",
                    "content": "Classify the input sensor into a weather categories"
                    + json.dumps(user_payload),
                },
            ],
        }
        response = {
            "choices": [
                {
                    "message": {
                        "content": json.dumps(
                            {
                                "Timestamp": user_payload["Timestamp"],
                                "Weather Classified Categories": labels,
                                "Reasons": ["synthetic"],
                            }
                        )
                    }
                }
            ]
        }
        label_lines.append(json.dumps([request, response]))

    with open(os.path.join(wdir, "daily.csv"), "w") as f:
        f.write(",".join(WEATHER_COLUMNS) + "\n")
        for vals in rows:
            f.write(",".join(str(vals[c]) for c in WEATHER_COLUMNS) + "\n")
    with open(os.path.join(root, "response.jsonl"), "w") as f:
        f.write("\n".join(label_lines) + "\n")


def generate_synthetic_dataset(
    root: str,
    sites: Sequence[str] = ("Site_A_01", "Site_B_02"),
    n_days: int = 12,
    image_size: int = 64,
    seed: int = 0,
):
    """Full synthetic corpus: site folders + weather + labels under root."""
    os.makedirs(root, exist_ok=True)
    for i, site in enumerate(sites):
        generate_synthetic_site(
            root, site, n_days=n_days, image_size=image_size,
            station_id=1000 + i, seed=seed + i,
        )
    generate_synthetic_weather(root, n_days=n_days, seed=seed + 100)
    return root
