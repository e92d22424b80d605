"""Dataset plugins of the port: coco (cocokp) and posetrack (cocokpst,
posetrack2018, posetrack2017), registered in ``datasets.factory``."""
