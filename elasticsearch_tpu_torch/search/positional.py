"""Distance units and great-circle distance (the geo part of
``elasticsearch_tpu/search/positional.py``, ``:554-585``).

The geo aggregations (``search/aggs_geo.py``) read these. The reference
module's queries (``intervals``, the span family, ``more_like_this``,
``distance_feature``) and ``search/intervals.py`` are not ported yet
(ROADMAP A6b): they need ``query_dsl`` parts the port does not have.
"""

from __future__ import annotations

import re

import numpy as np

from ..common.errors import IllegalArgumentError

_DIST_METERS = {"mm": 1e-3, "millimeters": 1e-3, "cm": 1e-2,
                "centimeters": 1e-2, "m": 1.0, "meters": 1.0,
                "km": 1000.0, "kilometers": 1000.0,
                "mi": 1609.344, "miles": 1609.344, "yd": 0.9144,
                "yards": 0.9144, "ft": 0.3048, "feet": 0.3048,
                "in": 0.0254, "inch": 0.0254, "nmi": 1852.0, "NM": 1852.0,
                "nauticalmiles": 1852.0, None: 1.0}
_DIST_RE = re.compile(
    r"^\s*(-?\d+(?:\.\d+)?)\s*(" +
    "|".join(sorted((u for u in _DIST_METERS if u), key=len, reverse=True)) +
    r")?\s*$")

EARTH_MEAN_RADIUS_M = 6371008.7714      # Lucene GeoUtils.EARTH_MEAN_RADIUS


def parse_distance_meters(value) -> float:
    if isinstance(value, (int, float)):
        return float(value)
    m = _DIST_RE.match(str(value))
    if not m:
        raise IllegalArgumentError(f"failed to parse distance [{value}]")
    return float(m.group(1)) * _DIST_METERS[m.group(2)]


def haversine_meters(lat1, lon1, lat2, lon2):
    """Vectorized great-circle distance (numpy) in meters."""
    p1, p2 = np.radians(lat1), np.radians(lat2)
    dp = p2 - p1
    dl = np.radians(lon2) - np.radians(lon1)
    a = (np.sin(dp / 2.0) ** 2 +
         np.cos(p1) * np.cos(p2) * np.sin(dl / 2.0) ** 2)
    return 2.0 * EARTH_MEAN_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))
