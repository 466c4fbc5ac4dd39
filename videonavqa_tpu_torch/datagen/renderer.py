"""Pluggable rendering backends for dataset generation.

The reference renders SUNCG houses through a C++ House3D fork
(scripts/trajectory_gen.py:12-14,82-89). That stays an optional external
backend behind the same three-mode interface (RGB / SEMANTIC / DEPTH); the
in-tree ``SyntheticRenderer`` ray-casts procedurally generated boxy houses so
trajectory observation, question generation and video rendering run end-to-end
hermetically (tests, fixtures, CI).

Pose convention matches House3D: (x, y, z, yaw_degrees), y up, camera height
1.2 (scripts/trajectory_gen.py:109-115); depth images are scaled so 255 = 20 m
(scripts/trajectory_gen.py:624).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from videonavqa_tpu_torch.datagen.ontology import (
    ALL_SIMPLE_ROOM_TYPES, ANSWER_VOCAB, QUERY_OBJECTS,
)
from videonavqa_tpu_torch.datagen.scene import HouseObject, HouseRoom
from videonavqa_tpu_torch.utils import constants as C

ANSWER_COLORS = ["black", "blue", "brown", "green", "grey", "maroon", "tan",
                 "teal", "white"]

# Synthetic houses only use room/object types whose query answers exist in the
# 70-class answer vocabulary (the real dataset's 'fan'/'pillow'/... objects and
# rare composite room types never produced answers, so they have no class).
ROOM_TYPE_CHOICES = [t for t in ALL_SIMPLE_ROOM_TYPES if t in ANSWER_VOCAB]
COMPOSITE_ROOM_CHOICES = sorted(k for k in ANSWER_VOCAB if "|" in k)
OBJ_CLASS_CHOICES = sorted((QUERY_OBJECTS & set(ANSWER_VOCAB)) - {"door"})

# Deterministic distinct semantic color per queryable class.
SEMANTIC_COLORS = {
    name: ((37 * i + 50) % 256, (101 * i + 80) % 256, (197 * i + 30) % 256)
    for i, name in enumerate(sorted(QUERY_OBJECTS))
}
RGB_TO_OBJECT = {rgb: name for name, rgb in SEMANTIC_COLORS.items()}

_BGR_OF_COLOR = {  # for the crude RGB pass
    "black": (20, 20, 20), "blue": (200, 60, 40), "brown": (40, 70, 130),
    "green": (60, 160, 60), "grey": (128, 128, 128), "maroon": (40, 40, 120),
    "tan": (140, 180, 210), "teal": (128, 128, 0), "white": (235, 235, 235),
}


class RenderMode:
    RGB = "rgb"
    SEMANTIC = "semantic"
    DEPTH = "depth"


@dataclasses.dataclass
class SyntheticHouse:
    rooms: list          # list[HouseRoom]
    objects: list        # flat list[HouseObject] (same instances as in rooms)
    room_grid: dict      # (gx, gz) -> room index, for path building
    room_size: float


def generate_synthetic_house(rng: np.random.RandomState, *, num_rooms=4,
                             objects_per_room=(2, 6), room_size=6.0):
    """A 1xN strip of rooms with varied widths (so room-size-comparison
    questions have both answers), each with a few colored box objects."""
    rooms, all_objects, grid = [], [], {}
    obj_classes = OBJ_CLASS_CHOICES
    node_counter = 0
    widths = rng.uniform(0.75 * room_size, 1.45 * room_size, size=num_rooms)
    x_edges = np.concatenate([[0.0], np.cumsum(widths)])
    for gx in range(num_rooms):
        x0, z0 = float(x_edges[gx]), 0.0
        room_w = float(widths[gx])
        if rng.rand() < 0.15:
            types = COMPOSITE_ROOM_CHOICES[rng.randint(len(COMPOSITE_ROOM_CHOICES))].split("|")
        else:
            types = [ROOM_TYPE_CHOICES[rng.randint(len(ROOM_TYPE_CHOICES))]]
        objs = []
        for _ in range(rng.randint(objects_per_room[0], objects_per_room[1] + 1)):
            w, d = rng.uniform(0.4, 1.4, size=2)
            h = rng.uniform(0.4, 1.8)
            ox = rng.uniform(x0 + 0.7, x0 + room_w - 0.7 - w)
            oz = rng.uniform(z0 + 0.7, z0 + room_size - 0.7 - d)
            obj = HouseObject(
                node=f".0_{node_counter}",
                coarse_class=obj_classes[rng.randint(len(obj_classes))],
                bbox={"min": [ox, 0.0, oz], "max": [ox + w, h, oz + d]},
                color=ANSWER_COLORS[rng.randint(len(ANSWER_COLORS))])
            node_counter += 1
            objs.append(obj)
            all_objects.append(obj)
        # a door on each shared wall
        if gx > 0:
            door = HouseObject(
                node=f".0_{node_counter}",
                coarse_class="door",
                bbox={"min": [x0 - 0.05, 0.0, z0 + room_size / 2 - 0.6],
                      "max": [x0 + 0.05, 2.0, z0 + room_size / 2 + 0.6]},
                color=None)
            node_counter += 1
            objs.append(door)
            all_objects.append(door)
        rooms.append(HouseRoom(
            types=types,
            bbox={"min": [x0, 0.0, z0], "max": [x0 + room_w, 2.5, z0 + room_size]},
            objects=objs))
        grid[(gx, 0)] = len(rooms) - 1
    return SyntheticHouse(rooms=rooms, objects=all_objects, room_grid=grid,
                          room_size=room_size)


def generate_path(house: SyntheticHouse, room_a: int, room_b: int,
                  rng: np.random.RandomState, step=0.4):
    """Waypoint path through doorway midpoints between two rooms of the strip,
    discretized with headings — the synthetic stand-in for House3D shortest
    paths (scripts/trajectory_gen.py:288-311)."""
    def center(idx, jitter=1.0):
        b = house.rooms[idx].bbox
        cx = (b["min"][0] + b["max"][0]) / 2 + rng.uniform(-jitter, jitter)
        cz = (b["min"][2] + b["max"][2]) / 2 + rng.uniform(-jitter, jitter)
        return np.array([cx, cz])

    lo, hi = min(room_a, room_b), max(room_a, room_b)
    waypoints = [center(room_a)]
    indices = range(lo + 1, hi + 1) if room_b > room_a else range(hi, lo, -1)
    for idx in indices:
        b = house.rooms[idx].bbox
        waypoints.append(np.array([b["min"][0], (b["min"][2] + b["max"][2]) / 2]))
    waypoints.append(center(room_b))

    coors = []
    for w0, w1 in zip(waypoints[:-1], waypoints[1:]):
        seg = w1 - w0
        dist = float(np.linalg.norm(seg))
        if dist < 1e-6:
            continue
        yaw = math.degrees(math.atan2(seg[1], seg[0]))
        for i in range(max(1, int(dist / step))):
            p = w0 + seg * (i / max(1, int(dist / step)))
            coors.append((float(p[0]), 1.2, float(p[1]), yaw))
    coors.append((float(waypoints[-1][0]), 1.2, float(waypoints[-1][1]),
                  coors[-1][3] if coors else 0.0))
    return coors


class SyntheticRenderer:
    """Column ray-caster over a SyntheticHouse.

    For each image column a ray is cast in the floor plane; the nearest object
    bbox (or wall) hit fills that column with the class's semantic color and
    its distance (so component depths match closest-distance ground truth
    within the reference's rtol=0.25 matcher, scripts/trajectory_gen.py:444-445).
    """

    def __init__(self, house: SyntheticHouse, width=C.VID_WIDTH,
                 height=C.VID_HEIGHT, fov_deg=90.0, max_depth=20.0):
        self.house = house
        self.width, self.height = width, height
        self.fov = math.radians(fov_deg)
        self.max_depth = max_depth
        self.rgb_to_obj = RGB_TO_OBJECT

    def _cast(self, pose):
        """Returns per-column (hit_object | None, distance), vectorized over
        columns x objects (slab-method ray/AABB in the floor plane)."""
        x, _, z, yaw = pose
        yaw_r = math.radians(yaw)
        W = self.width
        ang = yaw_r + self.fov * (np.arange(W) / (W - 1) - 0.5)
        d = np.stack([np.cos(ang), np.sin(ang)], axis=1)  # [W, 2]
        origin = np.array([x, z])

        boxes = self._object_boxes()  # ([N,2] mins, [N,2] maxs) in (x, z)
        if boxes is not None:
            mins, maxs = boxes
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = np.where(np.abs(d) > 1e-9, 1.0 / d, np.inf)  # [W,2]
                t1 = (mins[None] - origin) * inv[:, None, :]  # [W,N,2]
                t2 = (maxs[None] - origin) * inv[:, None, :]
            lo = np.minimum(t1, t2)
            hi = np.maximum(t1, t2)
            # parallel rays: inside the slab -> (-inf, inf), outside -> miss
            inside = (origin >= mins) & (origin <= maxs)  # [N,2]
            parallel = np.abs(d)[:, None, :] <= 1e-9      # [W,1,2] -> broadcast [W,N,2]
            lo = np.where(parallel, np.where(inside[None], -np.inf, np.inf), lo)
            hi = np.where(parallel, np.where(inside[None], np.inf, -np.inf), hi)
            tmin = np.maximum(lo[..., 0], lo[..., 1])
            tmax = np.minimum(hi[..., 0], hi[..., 1])
            tmin = np.maximum(tmin, 0.0)
            t_entry = np.where((tmin <= tmax) & (tmin > 1e-6), tmin, np.inf)  # [W,N]
            obj_idx = np.argmin(t_entry, axis=1)
            obj_t = t_entry[np.arange(W), obj_idx]
        else:
            obj_idx = np.zeros(W, dtype=np.int64)
            obj_t = np.full(W, np.inf)

        bounds = self._house_bounds()
        wall_t = np.array([self._wall_distance(x, z, d[c], bounds) for c in range(W)])

        hits = []
        for c in range(W):
            if obj_t[c] < wall_t[c]:
                hits.append((self.house.objects[obj_idx[c]],
                             min(float(obj_t[c]), self.max_depth)))
            else:
                hits.append((None, min(float(wall_t[c]), self.max_depth)))
        return hits

    def _object_boxes(self):
        if not self.house.objects:
            return None
        if not hasattr(self, "_boxes_cache"):
            mins = np.array([[o.bbox["min"][0], o.bbox["min"][2]]
                             for o in self.house.objects])
            maxs = np.array([[o.bbox["max"][0], o.bbox["max"][2]]
                             for o in self.house.objects])
            self._boxes_cache = (mins, maxs)
        return self._boxes_cache

    def _house_bounds(self):
        mins = np.min([r.bbox["min"] for r in self.house.rooms], axis=0)
        maxs = np.max([r.bbox["max"] for r in self.house.rooms], axis=0)
        return {"min": list(mins), "max": list(maxs)}

    def _wall_distance(self, x, z, d, bounds):
        t_best = self.max_depth
        for axis, lim in ((0, bounds["min"][0]), (0, bounds["max"][0]),
                          (1, bounds["min"][2]), (1, bounds["max"][2])):
            if abs(d[axis]) > 1e-9:
                t = (lim - (x if axis == 0 else z)) / d[axis]
                if 1e-6 < t < t_best:
                    t_best = t
        return t_best

    def _column_extent(self, obj, dist):
        """Vertical pixel span of an object column at a given distance."""
        if obj is None:
            return 0, self.height
        top = obj.bbox["max"][1]
        bottom = obj.bbox["min"][1]
        cam_h = 1.2
        f = self.height  # crude focal length in pixels
        y0 = self.height // 2 - int((top - cam_h) / max(dist, 0.3) * f / 2)
        y1 = self.height // 2 - int((bottom - cam_h) / max(dist, 0.3) * f / 2)
        return max(0, y0), min(self.height, max(y1, y0 + 1))

    def render(self, pose, mode=RenderMode.RGB):
        hits = self._cast(pose)
        if mode == RenderMode.DEPTH:
            img = np.full((self.height, self.width), 255.0, dtype=np.float32)
        else:
            img = np.zeros((self.height, self.width, 3), dtype=np.uint8)
            img[: self.height // 2] = 60   # ceiling/walls backdrop
            img[self.height // 2:] = 30    # floor
        for col, (obj, dist) in enumerate(hits):
            y0, y1 = self._column_extent(obj, dist)
            if obj is None:
                if mode == RenderMode.DEPTH:
                    img[:, col] = min(dist, self.max_depth) * 255.0 / self.max_depth
                continue
            if mode == RenderMode.DEPTH:
                img[:, col] = min(self._wall_distance_for_col(pose, col), self.max_depth) \
                    * 255.0 / self.max_depth
                img[y0:y1, col] = min(dist, self.max_depth) * 255.0 / self.max_depth
            elif mode == RenderMode.SEMANTIC:
                img[y0:y1, col] = SEMANTIC_COLORS[obj.coarse_class]
            else:
                shade = max(0.25, 1.0 - dist / self.max_depth)
                base = _BGR_OF_COLOR.get(obj.color or "grey", (128, 128, 128))
                img[y0:y1, col] = tuple(int(c * shade) for c in base)
        return img

    def _wall_distance_for_col(self, pose, col):
        x, _, z, yaw = pose
        ang = math.radians(yaw) + self.fov * (col / (self.width - 1) - 0.5)
        d = np.array([math.cos(ang), math.sin(ang)])
        return self._wall_distance(x, z, d, self._house_bounds())


def _ray_aabb_2d(x, z, d, bbox):
    """Ray/AABB intersection in the floor plane; returns entry t or None."""
    tmin, tmax = 0.0, float("inf")
    for axis, o in ((0, x), (2, z)):
        di = d[0 if axis == 0 else 1]
        lo, hi = bbox["min"][axis], bbox["max"][axis]
        if abs(di) < 1e-9:
            if o < lo or o > hi:
                return None
            continue
        t1, t2 = (lo - o) / di, (hi - o) / di
        if t1 > t2:
            t1, t2 = t2, t1
        tmin, tmax = max(tmin, t1), min(tmax, t2)
        if tmin > tmax:
            return None
    return tmin if tmin > 1e-6 else None
