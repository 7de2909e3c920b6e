"""The items of a keyframe whose view kept no point (the loop's counter `empty_items` of `tools/infer_nuscenes.py: NuscenesInference`), a keyframe of the traced run's profiled keyframes: each still runs the whole net."""


def read(t: dict):
    return (t.get("counters") or {}).get("empty_items")
