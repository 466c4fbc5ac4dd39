"""Trajectory observation: what the agent saw along a path.

Rebuild of the reference's trajectory layer (scripts/trajectory_gen.py:95-557)
over the pluggable renderer interface:

- look-around insertion: on entering a new room, twelve 30-degree yaw steps
  sweep +-90 degrees (:121-141);
- room visit marking by bbox containment in the floor plane (:317-334);
- seen-object matching: per-frame semantic components' approximate depths
  matched against ground-truth distances (bbox-centre or closest-bbox) with
  np.isclose rtol=0.25, first-unseen-wins within the current room (:411-452);
- door matching searches the whole house and records the rooms adjacent to
  each seen door (:341-403).
"""

from __future__ import annotations

import numpy as np

from videonavqa_tpu_torch.datagen import geometry, vision
from videonavqa_tpu_torch.datagen.renderer import RenderMode
from videonavqa_tpu_torch.datagen.scene import SceneGraph

LOOKAROUND_YAW_STEPS = (1, 1, 1, -1, -1, -1, -1, -1, -1, 1, 1, 1)  # :136
DEPTH_MATCH_RTOL = 0.25  # :444


def add_lookarounds(coors, scene: SceneGraph):
    """Insert +-90-degree look-around frames at each room entry. Uses a scratch
    visit state so observation can re-run on the result."""
    current_room = None
    out = []
    for coor in coors:
        out.append(coor)
        room = scene.room_containing(coor[:3])
        if room is not None and room is not current_room:
            current_room = room
            c = out[-1]
            for yaw_add in LOOKAROUND_YAW_STEPS:
                c = (c[0], c[1], c[2], c[3] + 30 * yaw_add)
                out.append(c)
    return out


class TrajectoryObserver:
    """Walks a trajectory through the renderer, marking visited rooms and seen
    objects/doors on the scene graph."""

    def __init__(self, scene: SceneGraph, renderer, rgb_to_obj=None,
                 compute_seen_doors=False):
        self.scene = scene
        self.renderer = renderer
        self.rgb_to_obj = rgb_to_obj if rgb_to_obj is not None else renderer.rgb_to_obj
        self.compute_seen_doors = compute_seen_doors
        self.current_room = None
        self.doors = {}

    # ------------------------------------------------------------------
    def _update_current_room(self, pos):
        """Marks entry into a new room; returns True on entry (:317-334)."""
        probe = {"bbox": {"min": list(pos[:3]), "max": list(pos[:3])}}
        if self.current_room is not None and \
           geometry.is_contained(self.current_room, probe, axis=0) and \
           geometry.is_contained(self.current_room, probe, axis=2):
            return False
        room = self.scene.room_containing(pos[:3])
        if room is None:
            return False
        self.current_room = room
        self.scene.mark_visited(room)
        return True

    def _match_seen(self, objs_in_frame, agent_pos):
        """Mark current-room objects whose ground-truth distance matches an
        observed component depth (:411-452)."""
        if self.current_room is None:
            return []
        seen = []
        for obj_type, info in objs_in_frame.items():
            slot = self.current_room["objects"].get(obj_type)
            if slot is None:
                continue
            for depth in info["depths"][: info["count"]]:
                for entry in slot["obj_list"]:
                    if entry["seen"]:
                        continue
                    centre = [(a + b) / 2 for a, b in
                              zip(entry["bbox"]["min"], entry["bbox"]["max"])]
                    d_centre = geometry.point_distance_object(
                        agent_pos[:3], {"bbox": {"min": centre, "max": centre}})
                    d_bbox = geometry.point_distance_object(agent_pos[:3], entry)
                    if np.isclose(depth, d_centre, rtol=DEPTH_MATCH_RTOL) or \
                       np.isclose(depth, d_bbox, rtol=DEPTH_MATCH_RTOL):
                        entry["seen"] = True
                        slot["seen_count"] += 1
                        seen.append(entry)
                        break
        return seen

    def _match_doors(self, objs_in_frame, agent_pos):
        """House-wide door matching (:370-403)."""
        info = objs_in_frame.get("door")
        if info is None:
            return []
        doors_seen = []
        for depth in info["depths"][: info["count"]]:
            for room in self.scene.rooms():
                slot = room["objects"].get("door")
                if slot is None:
                    continue
                matched = False
                for entry in slot["obj_list"]:
                    centre = [(a + b) / 2 for a, b in
                              zip(entry["bbox"]["min"], entry["bbox"]["max"])]
                    d_centre = geometry.point_distance_object(
                        agent_pos[:3], {"bbox": {"min": centre, "max": centre}})
                    d_bbox = geometry.point_distance_object(agent_pos[:3], entry)
                    if np.isclose(depth, d_centre, rtol=DEPTH_MATCH_RTOL) or \
                       np.isclose(depth, d_bbox, rtol=DEPTH_MATCH_RTOL):
                        doors_seen.append(entry)
                        matched = True
                        break
                if matched:
                    break
        return doors_seen

    def _adjacent_rooms_for_door(self, door_obj):
        """The rooms on either side of a door (:341-361)."""
        door_obj["adjacent_rooms"] = [door_obj["room_id"]]
        if self.current_room is not None and \
           door_obj["room_id"] != self.current_room["room_id"]:
            door_obj["adjacent_rooms"].append(self.current_room["room_id"])
            return
        for room in self.scene.rooms():
            if room["room_id"] == door_obj["room_id"]:
                continue
            if geometry.is_contained(room, door_obj, axis=0) or \
               geometry.is_contained(room, door_obj, axis=2):
                door_obj["adjacent_rooms"].append(room["room_id"])
                return

    # ------------------------------------------------------------------
    def observe(self, coors, return_objects_in_frames=False):
        """Process every frame of the trajectory (:459-508)."""
        self.current_room = None
        per_frame = []
        for coor in coors:
            semantic = self.renderer.render(coor, RenderMode.SEMANTIC)
            depth = self.renderer.render(coor, RenderMode.DEPTH)
            self._update_current_room(coor)
            objs = vision.objects_in_frame(semantic, self.rgb_to_obj, depth)
            if return_objects_in_frames:
                per_frame.append(list(objs))
            self._match_seen(objs, coor)
            if self.compute_seen_doors:
                for door in self._match_doors(objs, coor):
                    if door["node"] not in self.doors:
                        self.doors[door["node"]] = door
                        self._adjacent_rooms_for_door(door)
        return per_frame if return_objects_in_frames else None

    def render_video(self, coors):
        """RGB frames [T, H, W, 3] u8 BGR for mp4 writing
        (scripts/trajectory_gen.py:147-168)."""
        return np.stack([self.renderer.render(c, RenderMode.RGB) for c in coors])
