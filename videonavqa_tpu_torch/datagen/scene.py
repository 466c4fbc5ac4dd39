"""Ground-truth scene graph: the house description the trajectory layer builds
and the question layer queries.

Mirrors the reference's nested house dict (scripts/trajectory_gen.py:216-273):
rooms keyed by composite room type, each room carrying typed object lists with
per-object dicts ``{node, bbox, color, seen, room_location, obj_type, room_id}``
and visit/seen bookkeeping. The question programs operate directly on these
leaf dicts, so their key set is part of the behavior contract.
"""

from __future__ import annotations

import dataclasses

from videonavqa_tpu_torch.datagen import geometry
from videonavqa_tpu_torch.datagen.ontology import QUERY_OBJECTS, normalize_room_types


class ItemInfo:
    """Named wrapper for nearby-pair computation (scripts/trajectory_gen.py:42-46)."""

    def __init__(self, name, meta):
        self.name = name
        self.meta = meta
        self.type = "object"


@dataclasses.dataclass
class HouseObject:
    """Ground-truth object as supplied by a house model/renderer backend."""
    node: str
    coarse_class: str
    bbox: dict
    color: str | None = None


@dataclasses.dataclass
class HouseRoom:
    """Ground-truth room: raw type list (pre-normalization) + bbox + objects."""
    types: list
    bbox: dict
    objects: list  # list[HouseObject]


class SceneGraph:
    """Built house description with visit/seen state."""

    def __init__(self, rooms: list[HouseRoom]):
        # room_type -> {'room_list': [...], 'count', 'been_here_count'}
        self.by_type: dict[str, dict] = {}
        room_unique_id = 0
        for room in rooms:
            room_type = "|".join(normalize_room_types(list(room.types)))
            bucket = self.by_type.setdefault(
                room_type, {"room_list": [], "count": 0, "been_here_count": 0})
            bucket["count"] += 1
            room_unique_id += 1
            room_desc = {
                "been_here": False,
                "room_type": room_type,
                "bbox": room.bbox,
                "objects": {},
                "room_id": room_type + str(room_unique_id),
            }
            for obj in room.objects:
                if obj.coarse_class not in QUERY_OBJECTS:
                    continue
                slot = room_desc["objects"].setdefault(
                    obj.coarse_class, {"obj_list": [], "count": 0, "seen_count": 0})
                slot["count"] += 1
                slot["obj_list"].append({
                    "node": obj.node,
                    "bbox": obj.bbox,
                    "color": obj.color,
                    "seen": False,
                    "room_location": room_type,
                    "obj_type": obj.coarse_class,
                    "room_id": room_desc["room_id"],
                })
            bucket["room_list"].append(room_desc)

    # ------------------------------------------------------------------
    # Iteration / lookup
    # ------------------------------------------------------------------
    def rooms(self):
        for bucket in self.by_type.values():
            yield from bucket["room_list"]

    def room_containing(self, pos_xyz):
        """First room whose bbox contains the position in the floor plane
        (scripts/trajectory_gen.py:317-334's search order)."""
        probe = {"bbox": {"min": list(pos_xyz), "max": list(pos_xyz)}}
        for room in self.rooms():
            if geometry.is_contained(room, probe, axis=0) and \
               geometry.is_contained(room, probe, axis=2):
                return room
        return None

    def mark_visited(self, room):
        if not room["been_here"]:
            room["been_here"] = True
        self.by_type[room["room_type"]]["been_here_count"] += 1

    # ------------------------------------------------------------------
    # The query surface consumed by question generation
    # (scripts/trajectory_gen.py:521-596)
    # ------------------------------------------------------------------
    def get_all_objects(self, include_unseen_objects=False,
                        include_objects_in_all_rooms=False):
        out = []
        for room in self.rooms():
            if not room["been_here"] and not include_objects_in_all_rooms:
                continue
            for slot in room["objects"].values():
                out.extend(o for o in slot["obj_list"]
                           if o["seen"] or include_unseen_objects)
        return out

    def get_all_rooms(self, include_unseen_rooms=False):
        return [{"been_here": True, "room_type": r["room_type"],
                 "bbox": r["bbox"], "room_id": r["room_id"]}
                for r in self.rooms() if r["been_here"] or include_unseen_rooms]

    def get_all_nearby_object_pairs(self, *, hthreshold=0.3, vthreshold=0.2):
        all_pairs = {"on": [], "next_to": []}
        for room in self.rooms():
            if not room["been_here"]:
                continue
            items = []
            for obj_type, slot in room["objects"].items():
                cnt = 0
                for entry in slot["obj_list"]:
                    if not entry["seen"]:
                        continue
                    cnt += 1
                    items.append(ItemInfo(name=obj_type + str(cnt), meta=entry))
            if items:
                pairs = geometry.nearby_pairs(
                    items, hthreshold=hthreshold, vthreshold=vthreshold)
                for rel in ("on", "next_to"):
                    all_pairs[rel] += pairs[rel]
        return all_pairs
