def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with nvcc (skips inside the test when "
        "torch.cuda.is_available() is false)")
