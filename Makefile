# ssqueeze_rs_tpu developer entry points

.PHONY: test bench smoke native examples clean

test:            ## CPU suite (8 virtual devices, float64)
	python -m pytest tests/ -q

bench:           ## headline metric on the attached GPU (one JSON line)
	python bench.py

smoke:           ## main path at full size on one GPU, checked against references
	python chip_smoke.py

native:          ## build the C++ host runtime (libssq_native.so)
	$(MAKE) -C native

examples:        ## run the CPU-friendly examples
	JAX_PLATFORMS=cpu python examples/readme_example.py
	JAX_PLATFORMS=cpu python examples/component_separation.py

clean:
	$(MAKE) -C native clean
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
