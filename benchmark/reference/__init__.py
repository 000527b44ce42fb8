"""Plain PyTorch reference of the render the benchmark times."""
