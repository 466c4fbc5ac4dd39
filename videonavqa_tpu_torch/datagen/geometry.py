"""Axis-aligned bbox geometry for the scene-graph layer.

Provides the surface the reference imports from the EmbodiedQA fork's
HouseParse (scripts/trajectory_gen.py:16,59: isContained, getClosestDistance,
getNearbyPairs) plus the question-side bbox comparisons
(scripts/question_gen.py:317-332). Coordinates follow House3D's convention:
y (axis 1) is up; the floor plane is (x, z) = axes (0, 2). Boxes are dicts
``{'min': [x,y,z], 'max': [x,y,z]}``.
"""

from __future__ import annotations

import math


def bbox_volume(box):
    return math.prod(box["max"][i] - box["min"][i] for i in range(3))


def bbox_larger(box1, box2, threshold):
    """True if box1's volume exceeds box2's by at least ``threshold`` fraction
    (scripts/question_gen.py:326-332; comp_rel uses 0.25, comp_sup 0.1)."""
    v1, v2 = bbox_volume(box1), bbox_volume(box2)
    return (v1 - v2) / v2 >= threshold


def is_contained(container, item, axis: int) -> bool:
    """Containment of item's bbox within container's bbox along one axis."""
    cbox, ibox = container["bbox"], item["bbox"]
    return cbox["min"][axis] <= ibox["min"][axis] and ibox["max"][axis] <= cbox["max"][axis]


def _axis_gap(b1, b2, axis: int) -> float:
    """Separation between two boxes along an axis (0 when overlapping)."""
    return max(0.0, b1["min"][axis] - b2["max"][axis], b2["min"][axis] - b1["max"][axis])


def closest_distance(obj1, obj2) -> float:
    """Euclidean closest distance between two bboxes (0 if intersecting)."""
    return math.sqrt(sum(_axis_gap(obj1["bbox"], obj2["bbox"], a) ** 2 for a in range(3)))


def horizontal_distance(obj1, obj2) -> float:
    return math.sqrt(sum(_axis_gap(obj1["bbox"], obj2["bbox"], a) ** 2 for a in (0, 2)))


def point_distance_object(point_xyz, obj) -> float:
    """Distance from a point (e.g. the agent position) to an object's bbox."""
    probe = {"bbox": {"min": list(point_xyz), "max": list(point_xyz)}}
    return closest_distance(probe, obj)


def nearby_pairs(items, *, hthreshold: float, vthreshold: float):
    """Spatial relations between ItemInfo-wrapped objects:

    - ``on``:      a rests on b — a's bottom within ``vthreshold`` above b's
                   top and their footprints overlapping in the floor plane;
    - ``next_to``: horizontally within ``hthreshold`` with overlapping vertical
                   extents, for distinct non-stacked objects.

    Returns {'on': [(a, b, dist)], 'next_to': [(a, b, dist)]} with a, b the
    ItemInfo wrappers (the question layer reads ``pair[0].meta``/``pair[1].meta``,
    scripts/question_gen.py:480-491). Defaults in the reference CLI:
    hthreshold 0.3, vthreshold 0.2 (scripts/trajectory_gen.py:33-34).
    """
    pairs = {"on": [], "next_to": []}
    for a in items:
        for b in items:
            if a is b or a.meta is b.meta:
                continue
            abox, bbox = a.meta["bbox"], b.meta["bbox"]
            h_gap = max(_axis_gap(abox, bbox, 0), _axis_gap(abox, bbox, 2))
            v_overlap = min(abox["max"][1], bbox["max"][1]) - max(abox["min"][1], bbox["min"][1])
            bottom_above_top = abox["min"][1] - bbox["max"][1]
            dist = closest_distance(a.meta, b.meta)
            if h_gap == 0.0 and 0.0 <= bottom_above_top <= vthreshold:
                pairs["on"].append((a, b, dist))
            elif h_gap <= hthreshold and v_overlap > 0.0:
                pairs["next_to"].append((a, b, dist))
    return pairs
