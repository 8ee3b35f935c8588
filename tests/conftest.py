def pytest_configure(config):
    # tests of the PyTorch port's hand-written CUDA kernels (tests/test_torch_cuda.py)
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc; skips without them"
    )
