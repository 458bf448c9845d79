"""Geometry parsing + spatial relations for ``geo_shape``.

Reference: ``x-pack/plugin/spatial/`` + ``server/.../common/geo/`` —
``GeoShapeQueryBuilder`` parses GeoJSON/WKT into a ``Geometry`` tree and
evaluates INTERSECTS / DISJOINT / WITHIN / CONTAINS against BKD-indexed
triangles.  Here geometries normalize into primitive lists (points,
lines, polygons-with-holes) and relations evaluate with exact
host-side predicates (ray-cast point-in-polygon, orientation-test
segment intersection) — O(vertices) per doc instead of a BKD tree,
the right trade for this build where geo_shape docs are orders of
magnitude rarer than text (the hot path stays on device).

Supported input: GeoJSON (Point, MultiPoint, LineString,
MultiLineString, Polygon, MultiPolygon, GeometryCollection + the ES
``envelope`` extension) and WKT (POINT, MULTIPOINT, LINESTRING,
MULTILINESTRING, POLYGON, MULTIPOLYGON, ENVELOPE, GEOMETRYCOLLECTION).
Coordinates are [lon, lat] like the reference.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from ..common.errors import IllegalArgumentError

Coord = Tuple[float, float]                      # (lon, lat)
Ring = List[Coord]


class Geometry:
    """Normalized form: bags of primitives + a bounding box."""

    def __init__(self):
        self.points: List[Coord] = []
        self.lines: List[Ring] = []
        #: each polygon is (shell, [holes...]) with closed rings
        self.polygons: List[Tuple[Ring, List[Ring]]] = []

    # -- construction ---------------------------------------------------
    def add_point(self, lon: float, lat: float) -> None:
        self.points.append((float(lon), float(lat)))

    def add_line(self, coords: Sequence[Sequence[float]]) -> None:
        if len(coords) < 2:
            raise IllegalArgumentError(
                "at least two points required for linestring")
        self.lines.append([(float(c[0]), float(c[1])) for c in coords])

    def add_polygon(self, rings: Sequence[Sequence[Sequence[float]]]
                    ) -> None:
        if not rings:
            raise IllegalArgumentError("polygon requires a shell ring")
        norm: List[Ring] = []
        for ring in rings:
            r = [(float(c[0]), float(c[1])) for c in ring]
            if len(r) < 4 or r[0] != r[-1]:
                raise IllegalArgumentError(
                    "invalid LinearRing: must be closed with at least "
                    "4 points")
            norm.append(r)
        self.polygons.append((norm[0], norm[1:]))

    def add_envelope(self, coords) -> None:
        """ES envelope: [[minLon, maxLat], [maxLon, minLat]]."""
        (x1, y2), (x2, y1) = ((float(coords[0][0]), float(coords[0][1])),
                              (float(coords[1][0]), float(coords[1][1])))
        shell = [(x1, y1), (x2, y1), (x2, y2), (x1, y2), (x1, y1)]
        self.polygons.append((shell, []))

    @property
    def empty(self) -> bool:
        return not (self.points or self.lines or self.polygons)

    def bbox(self) -> Tuple[float, float, float, float]:
        xs: List[float] = []
        ys: List[float] = []
        for x, y in self.points:
            xs.append(x)
            ys.append(y)
        for line in self.lines:
            for x, y in line:
                xs.append(x)
                ys.append(y)
        for shell, _holes in self.polygons:
            for x, y in shell:
                xs.append(x)
                ys.append(y)
        return (min(xs), min(ys), max(xs), max(ys))


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

def parse_geometry(value) -> Geometry:
    if isinstance(value, str):
        return _parse_wkt(value)
    if isinstance(value, dict):
        g = Geometry()
        _parse_geojson(value, g)
        return g
    raise IllegalArgumentError(
        f"unable to parse geometry from [{value!r}]")


def _parse_geojson(obj: dict, g: Geometry) -> None:
    t = str(obj.get("type", "")).lower()
    coords = obj.get("coordinates")
    if t == "point":
        g.add_point(coords[0], coords[1])
    elif t == "multipoint":
        for c in coords:
            g.add_point(c[0], c[1])
    elif t == "linestring":
        g.add_line(coords)
    elif t == "multilinestring":
        for line in coords:
            g.add_line(line)
    elif t == "polygon":
        g.add_polygon(coords)
    elif t == "multipolygon":
        for rings in coords:
            g.add_polygon(rings)
    elif t == "envelope":
        g.add_envelope(coords)
    elif t == "geometrycollection":
        for sub in obj.get("geometries") or []:
            _parse_geojson(sub, g)
    else:
        raise IllegalArgumentError(f"unknown geometry type [{t}]")


_WKT_NUM = r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?"


def _wkt_coords(text: str) -> List[Coord]:
    out = []
    for pair in text.split(","):
        nums = re.findall(_WKT_NUM, pair)
        if len(nums) < 2:
            raise IllegalArgumentError(
                f"invalid WKT coordinates [{pair.strip()}]")
        out.append((float(nums[0]), float(nums[1])))
    return out


def _split_rings(body: str) -> List[str]:
    """Split '(r1), (r2)' at depth-0 commas."""
    parts, depth, cur = [], 0, []
    for ch in body:
        if ch == "(":
            depth += 1
            if depth == 1:
                cur = []
                continue
        elif ch == ")":
            depth -= 1
            if depth == 0:
                parts.append("".join(cur))
                continue
        if depth >= 1:
            cur.append(ch)
    return parts


def _parse_wkt(text: str) -> Geometry:
    g = Geometry()
    _parse_wkt_into(text.strip(), g)
    return g


def _parse_wkt_into(text: str, g: Geometry) -> None:
    m = re.match(r"\s*([A-Za-z]+)\s*\((.*)\)\s*$", text, re.S)
    if m is None:
        raise IllegalArgumentError(f"unable to parse WKT [{text}]")
    kind = m.group(1).upper()
    body = m.group(2).strip()
    if kind == "POINT":
        (c,) = _wkt_coords(body)
        g.add_point(*c)
    elif kind == "MULTIPOINT":
        cleaned = body.replace("(", "").replace(")", "")
        for c in _wkt_coords(cleaned):
            g.add_point(*c)
    elif kind == "LINESTRING":
        g.add_line(_wkt_coords(body))
    elif kind == "MULTILINESTRING":
        for seg in _split_rings(body):
            g.add_line(_wkt_coords(seg))
    elif kind == "POLYGON":
        g.add_polygon([_wkt_coords(r) for r in _split_rings(body)])
    elif kind == "MULTIPOLYGON":
        depth, cur, polys = 0, [], []
        for ch in body:
            if ch == "(":
                depth += 1
                if depth == 1:
                    cur = []
                    continue
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    polys.append("".join(cur))
                    continue
            if depth >= 1:
                cur.append(ch)
        for p in polys:
            g.add_polygon([_wkt_coords(r) for r in _split_rings(p)])
    elif kind == "ENVELOPE":
        # WKT ENVELOPE(minLon, maxLon, maxLat, minLat) — ES order
        nums = [float(x) for x in re.findall(_WKT_NUM, body)]
        if len(nums) != 4:
            raise IllegalArgumentError(f"invalid ENVELOPE [{body}]")
        g.add_envelope([[nums[0], nums[2]], [nums[1], nums[3]]])
    elif kind == "GEOMETRYCOLLECTION":
        depth, cur, subs = 0, [], []
        start = 0
        # split top-level geometries at depth-0 commas
        for i, ch in enumerate(body):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "," and depth == 0:
                subs.append(body[start:i])
                start = i + 1
        subs.append(body[start:])
        for s in subs:
            _parse_wkt_into(s.strip(), g)
    else:
        raise IllegalArgumentError(f"unknown WKT type [{kind}]")


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------

def _orient(a: Coord, b: Coord, c: Coord) -> float:
    return (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])


def _on_segment(a: Coord, b: Coord, p: Coord) -> bool:
    return (min(a[0], b[0]) - 1e-12 <= p[0] <= max(a[0], b[0]) + 1e-12
            and min(a[1], b[1]) - 1e-12 <= p[1]
            <= max(a[1], b[1]) + 1e-12)


def _segments_intersect(a: Coord, b: Coord, c: Coord, d: Coord) -> bool:
    o1, o2 = _orient(a, b, c), _orient(a, b, d)
    o3, o4 = _orient(c, d, a), _orient(c, d, b)
    if ((o1 > 0) != (o2 > 0)) and ((o3 > 0) != (o4 > 0)) \
            and o1 != 0 and o2 != 0 and o3 != 0 and o4 != 0:
        return True
    if o1 == 0 and _on_segment(a, b, c):
        return True
    if o2 == 0 and _on_segment(a, b, d):
        return True
    if o3 == 0 and _on_segment(c, d, a):
        return True
    if o4 == 0 and _on_segment(c, d, b):
        return True
    return False


def _point_in_ring(p: Coord, ring: Ring) -> bool:
    """Ray cast; boundary counts as inside."""
    x, y = p
    inside = False
    for i in range(len(ring) - 1):
        a, b = ring[i], ring[i + 1]
        if _orient(a, b, p) == 0 and _on_segment(a, b, p):
            return True
        if (a[1] > y) != (b[1] > y):
            xi = a[0] + (y - a[1]) * (b[0] - a[0]) / (b[1] - a[1])
            if x < xi:
                inside = not inside
    return inside


def _point_in_polygon(p: Coord, poly: Tuple[Ring, List[Ring]]) -> bool:
    shell, holes = poly
    if not _point_in_ring(p, shell):
        return False
    for h in holes:
        if _point_in_ring(p, h) and not _on_ring_boundary(p, h):
            return False
    return True


def _on_ring_boundary(p: Coord, ring: Ring) -> bool:
    for i in range(len(ring) - 1):
        if _orient(ring[i], ring[i + 1], p) == 0 and \
                _on_segment(ring[i], ring[i + 1], p):
            return True
    return False


def _rings_of(poly: Tuple[Ring, List[Ring]]) -> List[Ring]:
    return [poly[0]] + list(poly[1])


def _line_intersects_polygon(line: Ring,
                             poly: Tuple[Ring, List[Ring]]) -> bool:
    for p in line:
        if _point_in_polygon(p, poly):
            return True
    for ring in _rings_of(poly):
        for i in range(len(line) - 1):
            for j in range(len(ring) - 1):
                if _segments_intersect(line[i], line[i + 1],
                                       ring[j], ring[j + 1]):
                    return True
    return False


def _polygons_intersect(p1, p2) -> bool:
    if any(_point_in_polygon(v, p2) for v in p1[0]):
        return True
    if any(_point_in_polygon(v, p1) for v in p2[0]):
        return True
    for r1 in _rings_of(p1):
        for r2 in _rings_of(p2):
            for i in range(len(r1) - 1):
                for j in range(len(r2) - 1):
                    if _segments_intersect(r1[i], r1[i + 1],
                                           r2[j], r2[j + 1]):
                        return True
    return False


def _lines_intersect(l1: Ring, l2: Ring) -> bool:
    for i in range(len(l1) - 1):
        for j in range(len(l2) - 1):
            if _segments_intersect(l1[i], l1[i + 1], l2[j], l2[j + 1]):
                return True
    return False


def intersects(a: Geometry, b: Geometry) -> bool:
    # cheap bbox reject first
    if a.empty or b.empty:
        return False
    ax1, ay1, ax2, ay2 = a.bbox()
    bx1, by1, bx2, by2 = b.bbox()
    if ax2 < bx1 or bx2 < ax1 or ay2 < by1 or by2 < ay1:
        return False
    for p in a.points:
        if any(abs(p[0] - q[0]) < 1e-12 and abs(p[1] - q[1]) < 1e-12
               for q in b.points):
            return True
        if any(_on_line(p, line) for line in b.lines):
            return True
        if any(_point_in_polygon(p, poly) for poly in b.polygons):
            return True
    for line in a.lines:
        if any(_on_line(q, line) for q in b.points):
            return True
        if any(_lines_intersect(line, l2) for l2 in b.lines):
            return True
        if any(_line_intersects_polygon(line, poly)
               for poly in b.polygons):
            return True
    for poly in a.polygons:
        if any(_point_in_polygon(q, poly) for q in b.points):
            return True
        if any(_line_intersects_polygon(l2, poly) for l2 in b.lines):
            return True
        if any(_polygons_intersect(poly, p2) for p2 in b.polygons):
            return True
    return False


def _on_line(p: Coord, line: Ring) -> bool:
    for i in range(len(line) - 1):
        if _orient(line[i], line[i + 1], p) == 0 and \
                _on_segment(line[i], line[i + 1], p):
            return True
    return False


def _line_within_polygon(line: Ring,
                         poly: Tuple[Ring, List[Ring]]) -> bool:
    # all vertices inside, and each segment midpoint too (catches
    # concave escapes and hole crossings between two inside vertices)
    if not all(_point_in_polygon(p, poly) for p in line):
        return False
    for i in range(len(line) - 1):
        mid = ((line[i][0] + line[i + 1][0]) / 2,
               (line[i][1] + line[i + 1][1]) / 2)
        if not _point_in_polygon(mid, poly):
            return False
    return True


def _polygon_within_polygon(inner, outer) -> bool:
    if not all(_point_in_polygon(v, outer) for v in inner[0]):
        return False
    # no boundary crossing
    for r1 in _rings_of(inner):
        for r2 in _rings_of(outer):
            for i in range(len(r1) - 1):
                for j in range(len(r2) - 1):
                    a, b = r1[i], r1[i + 1]
                    c, d = r2[j], r2[j + 1]
                    o1, o2 = _orient(c, d, a), _orient(c, d, b)
                    if (o1 > 0) != (o2 > 0) and o1 != 0 and o2 != 0 \
                            and ((_orient(a, b, c) > 0)
                                 != (_orient(a, b, d) > 0)):
                        return False
    # an outer hole lying inside the inner shell means the inner
    # polygon covers excluded area (hole swallowed whole — no edge
    # crossings to catch it above)
    for hole in outer[1]:
        if any(_point_in_ring(v, inner[0])
               and not _on_ring_boundary(v, inner[0])
               for v in hole[:-1]):
            return False
    return True


def within(a: Geometry, b: Geometry) -> bool:
    """Every part of ``a`` lies inside ``b`` (b must have area)."""
    if a.empty or not b.polygons:
        return False
    for p in a.points:
        if not any(_point_in_polygon(p, poly) for poly in b.polygons):
            return False
    for line in a.lines:
        if not any(_line_within_polygon(line, poly)
                   for poly in b.polygons):
            return False
    for poly in a.polygons:
        if not any(_polygon_within_polygon(poly, outer)
                   for outer in b.polygons):
            return False
    return True


def relate(doc: Geometry, query: Geometry, relation: str) -> bool:
    relation = relation.lower()
    if relation == "intersects":
        return intersects(doc, query)
    if relation == "disjoint":
        return not intersects(doc, query)
    if relation == "within":
        return within(doc, query)
    if relation == "contains":
        return within(query, doc)
    raise IllegalArgumentError(
        f"invalid relation [{relation}]: must be one of [intersects, "
        f"disjoint, within, contains]")
