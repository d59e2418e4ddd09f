"""Tools that run the port on the card (stage_bench, patch_slots_probe,
device_time, select_ablation, phase_ablation, fast_ablation,
run_benchmarks), reference_band, which computes the OpenCV reference's
trajectories and bands on the CPU, and the user tools
make_synthetic_dataset and evaluate_trajectory."""
