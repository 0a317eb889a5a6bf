"""pytest settings of the benchmark's own tests (`portbench/tests/`):
the `card` marker for tests that need a CUDA card. Such a test decides in
its body whether a card is there and skips without one."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
