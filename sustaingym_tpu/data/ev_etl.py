"""EV-charging data compilers: MOER day-tables and session trace packs.

SURVEY.md §3.1: the reference rebuilds the charging network and event queue
from pandas frames EVERY episode (env.py:319-328). Here a whole date range is
compiled ONCE into dense arrays; an episode reset is an index gather.

Artifacts (cached .npz):
- MOER pack: (n_days, 289, 37) float32 — historical + 36-step forecasts per
  5-min row, one slab per LA-local day (mirrors MOERLoader.retrieve,
  /root/reference/sustaingym/data/load_moer.py:346-377).
- Trace pack: per day, up to MAX_EVS sessions with
  [arrival, departure, est_departure, requested_energy, station_idx]
  + validity mask (mirrors RealTraceGenerator._create_events,
  /root/reference/sustaingym/envs/evcharging/event_generation.py:293-328).
"""
from __future__ import annotations

import datetime as dt
import os
from zoneinfo import ZoneInfo

import numpy as np

from .paths import packed_path, raw_path

LA = ZoneInfo("America/Los_Angeles")
UTC = dt.timezone.utc
PERIOD_MIN = 5
STEPS_PER_DAY = 288
MOER_BA = "SGIP_CAISO_SCE"

# default seasonal ranges (evcharging/utils.py:48-64)
DEFAULT_DATE_RANGES = (
    ("2019-05-01", "2019-08-31"),
    ("2019-09-01", "2019-12-31"),
    ("2020-02-01", "2020-05-31"),
    ("2021-05-01", "2021-08-31"),
)
DEFAULT_PERIOD_TO_RANGE = {
    "Summer 2019": DEFAULT_DATE_RANGES[0],
    "Pre-COVID-19 Summer": DEFAULT_DATE_RANGES[0],
    "Fall 2019": DEFAULT_DATE_RANGES[1],
    "Pre-COVID-19 Fall": DEFAULT_DATE_RANGES[1],
    "Spring 2020": DEFAULT_DATE_RANGES[2],
    "In-COVID-19": DEFAULT_DATE_RANGES[2],
    "Summer 2021": DEFAULT_DATE_RANGES[3],
    "Post-COVID-19": DEFAULT_DATE_RANGES[3],
}

MAX_EVS = 128  # max sessions per day (caltech peak observed ~84)


def _parse_range(date_period) -> tuple[dt.date, dt.date]:
    if isinstance(date_period, str):
        date_period = DEFAULT_PERIOD_TO_RANGE[date_period]
    start = dt.date.fromisoformat(date_period[0])
    end = dt.date.fromisoformat(date_period[1])
    return start, end


def _days_in_range(start: dt.date, end: dt.date) -> list[dt.date]:
    out = []
    d = start
    while d <= end:
        out.append(d)
        d += dt.timedelta(days=1)
    return out


# ---------------------------------------------------------------------------
# MOER
# ---------------------------------------------------------------------------

def build_moer_pack(date_period, ba: str = MOER_BA, cache: bool = True
                    ) -> np.ndarray:
    """(n_days, 289, 37) float32 MOER pack for all days in the range."""
    start, end = _parse_range(date_period)
    cache_file = packed_path(f"moer_{ba}_{start}_{end}.npz")
    if cache and os.path.exists(cache_file):
        return np.load(cache_file)["moer"]

    # raw-CSV path (ranges without a committed pack): needs pandas
    import pandas as pd

    # load all months overlapping [start, end + 1 day]
    frames = []
    cur = dt.date(start.year, start.month, 1)
    end_month = dt.date(end.year, end.month, 1)
    while cur <= end_month:
        path = raw_path("moer", f"{ba}_{cur.year}-{cur.month:02d}.csv.gz")
        df = pd.read_csv(path, compression="gzip", index_col="time")
        df.index = pd.to_datetime(df.index, utc=True)
        frames.append(df)
        cur = (dt.date(cur.year + 1, 1, 1) if cur.month == 12
               else dt.date(cur.year, cur.month + 1, 1))
    df = pd.concat(frames)
    df = df[~df.index.duplicated(keep="first")].sort_index()

    days = _days_in_range(start, end)
    n_rows = STEPS_PER_DAY + 1
    out = np.zeros((len(days), n_rows, df.shape[1]), dtype=np.float32)
    values = df.to_numpy(dtype=np.float32)
    index = df.index
    for i, day in enumerate(days):
        t0 = dt.datetime.combine(day, dt.time(), tzinfo=LA).astimezone(UTC)
        t1 = t0 + dt.timedelta(days=1, minutes=PERIOD_MIN)
        lo = index.searchsorted(t0, side="left")
        hi = index.searchsorted(t1, side="left")
        rows = values[lo:hi]
        out[i, :len(rows)] = rows[:n_rows]
    if cache:
        np.savez_compressed(cache_file, moer=out)
    return out


# ---------------------------------------------------------------------------
# Real session traces
# ---------------------------------------------------------------------------

def _load_sessions(site: str, date_period):
    import pandas as pd

    start, end = _parse_range(date_period)
    for rng in DEFAULT_DATE_RANGES:
        if (dt.date.fromisoformat(rng[0]) <= start
                and end <= dt.date.fromisoformat(rng[1])):
            path = raw_path("evcharging", "acn_data", site,
                            f"{rng[0]} {rng[1]}.csv.gz")
            df = pd.read_csv(path, compression="gzip")
            for col in ("arrival", "departure", "estimated_departure"):
                df[col] = pd.to_datetime(df[col], utc=True).dt.tz_convert(
                    "America/Los_Angeles")
            return df
    raise FileNotFoundError(
        f"no packaged ACN data covers {date_period} for {site}")


def build_trace_pack(site: str, date_period, station_ids: tuple[str, ...],
                     requested_energy_cap: float = 100.0,
                     use_unclaimed: bool = False, cache: bool = True
                     ) -> dict[str, np.ndarray]:
    """Compiles real traces into dense day tables.

    Returns dict of arrays:
        ev_data: (n_days, MAX_EVS, 4) float32
                 [arrival, departure, est_departure, requested_energy]
        ev_station: (n_days, MAX_EVS) int32 station index
        ev_mask: (n_days, MAX_EVS) bool
    Filtering mirrors RealTraceGenerator._create_events
    (event_generation.py:293-328): claimed-only, station in network,
    same-(calendar)-day departures, est_departure > arrival.
    """
    start, end = _parse_range(date_period)
    cache_file = packed_path(
        f"evtrace_{site}_{start}_{end}_{int(use_unclaimed)}.npz")
    if cache and os.path.exists(cache_file):
        d = np.load(cache_file)
        return {k: d[k] for k in ("ev_data", "ev_station", "ev_mask")}

    df = _load_sessions(site, date_period)
    if not use_unclaimed:
        df = df[df["claimed"]]
    sid_to_idx = {s: i for i, s in enumerate(station_ids)}
    df = df[df["station_id"].isin(sid_to_idx)]

    days = _days_in_range(start, end)
    n_days = len(days)
    ev_data = np.zeros((n_days, MAX_EVS, 4), dtype=np.float32)
    ev_station = np.zeros((n_days, MAX_EVS), dtype=np.int32)
    ev_mask = np.zeros((n_days, MAX_EVS), dtype=bool)

    arr = df["arrival"]
    for i, day in enumerate(days):
        day_mask = np.array([a.date() == day for a in arr])
        sub = df[day_mask]
        if len(sub) == 0:
            continue
        # same-calendar-day departure filter: reference compares
        # day-of-month only (event_generation.py:314-315)
        max_dep = np.maximum(sub["departure"], sub["estimated_departure"])
        sub = sub[[m.day == day.day for m in max_dep]]
        if len(sub) == 0:
            continue
        k = 0
        for _, row in sub.iterrows():
            a = (row["arrival"].hour * 60 + row["arrival"].minute) // PERIOD_MIN
            d = (row["departure"].hour * 60 + row["departure"].minute) // PERIOD_MIN
            e = (row["estimated_departure"].hour * 60
                 + row["estimated_departure"].minute) // PERIOD_MIN
            if e <= a:
                continue
            if k >= MAX_EVS:
                break
            req = min(float(row["requested_energy (kWh)"]),
                      requested_energy_cap)
            ev_data[i, k] = (a, d, e, req)
            ev_station[i, k] = sid_to_idx[row["station_id"]]
            ev_mask[i, k] = True
            k += 1

    pack = {"ev_data": ev_data, "ev_station": ev_station, "ev_mask": ev_mask}
    if cache:
        np.savez_compressed(cache_file, **pack)
    return pack
