"""The points that a keyframe's six item views kept, summed (the loop's counter `kept_points` of `tools/infer_nuscenes.py: NuscenesInference`), a keyframe of the traced run's profiled keyframes: under the ±45° yaw crop about the lidar's front only the cameras facing front and back keep any."""


def read(t: dict):
    return (t.get("counters") or {}).get("kept_points")
