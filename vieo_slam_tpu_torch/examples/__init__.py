"""The example programs of the port, run as
`python -m vieo_slam_tpu_torch.examples.<name>`: evaluate_ntimes (the
scenario matrix), run_synthetic and run_euroc."""
