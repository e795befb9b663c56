"""The port's measurement tools, each run as
``python -m fourd_ray_tracing_tpu_torch.tools.<name>``: vpu_peak (the
card's sustained fp32 FMA rate, K7), grad_ablate (the value-and-grad
kernel's pass budget, K8), train_ablate, soft_ablate and fwd_ablate (the
stage ladders of the train step, the soft step and the forward kernel).
"""
