"""mam3slam_tpu — JAX-native centralized multi-agent multi-map visual SLAM.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the MAM3SLAM
reference (ORB-SLAM3-based C++, see SURVEY.md): batched ORB front end,
batched Gauss-Newton/LM back end with Schur reduction, on-device place
recognition, Sim3 map merging, and a centralized multi-agent server.
"""

__version__ = "0.1.0"
