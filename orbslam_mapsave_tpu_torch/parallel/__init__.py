"""Distributed bundle adjustment, full-map BA and relocalization queries
over torch.distributed ranks (port of `orbslam_mapsave_tpu/parallel/`)."""
