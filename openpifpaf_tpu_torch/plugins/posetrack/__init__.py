"""PoseTrack plugin of the port: the PoseTrack constants and the head
metas of ``cocokpst`` (tracking heads on still COCO images); the
posetrack2017/2018 data modules are not ported yet (ROADMAP A10)."""
