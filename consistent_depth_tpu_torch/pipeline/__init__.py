"""Pipeline stages of the port: the stage graph, video, COLMAP, scale
calibration, flow and the video export."""
