"""GPT weather-labelling requests (counterpart of
`ealdm_tpu/data/gpt_labels.py`): an OpenAI chat-completions request JSONL
asking for the 10-category weather classification of each daily sensor row
(the reference's `STDiff/GPTData.py`). Nothing is sent: `create_req_file` only
writes the request file, and `data/stdiff.py` parses the responses.
"""
from __future__ import annotations

import json
from typing import Dict, Sequence

import numpy as np

from .stdiff import WEATHER_CLASSES

MODEL_TYPE = "gpt-3.5-turbo-1106"

SYSTEM_DESC = (
    "You are an advanced weather classification assistant that classifies "
    "weather conditions based on input sensor data (timestamp, temperature, "
    "wind, humidity, pressure, solar radiation, rainfall). Classify the "
    "weather into the categories "
    + json.dumps(WEATHER_CLASSES)
    + ' and answer in JSON: {"Timestamp": ..., '
    '"Weather Classified Categories": [...], "Reasons": [...]}.'
)

_FIELDS = [
    "Average Temp", "Max Daily Temp", "Min Temp", "Wind Speed",
    "Wind Direction", "Max Wind Spd", "Minimum Wind Spd",
    "Mean Relative Humidity", "Atmospheric Pressure", "Mean Solar Radiation",
    "Total Rainfall",
]


def create_req_file(rows: Sequence[Dict], output: str):
    """rows: dicts with 'TIMESTAMP' (epoch seconds) + the _FIELDS values."""
    with open(output, "w") as f:
        for row in rows:
            payload = {
                "Timestamp": np.datetime_as_string(
                    np.datetime64(int(row["TIMESTAMP"]), "s"), timezone="UTC"
                )
            }
            for k in _FIELDS:
                payload[k] = float(row[k])
            req = {
                "model": MODEL_TYPE,
                "response_format": {"type": "json_object"},
                "messages": [
                    {"role": "system", "content": SYSTEM_DESC},
                    {
                        "role": "user",
                        "content": "Classify the input sensor into a weather categories"
                        + json.dumps(payload),
                    },
                ],
            }
            f.write(json.dumps(req) + "\n")
