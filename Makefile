# Convenience targets mirroring the reference build entries
# (reference Makefile: standalone | python | blender | clean).

PYTHON ?= python

.PHONY: all native test bench golden verify blender-zip blender-zip-torch clean

all: native

# native helper library (KD builder) — the "standalone core" build
native:
	$(PYTHON) native/build.py

test:
	$(PYTHON) -m pytest tests/ -x -q

bench: native
	$(PYTHON) bench.py

golden: native
	$(PYTHON) tools/golden_check.py

# full TPU golden sweep + bench, then machine-regenerate every published
# table (README + BASELINE.json) from the tool output
verify: native
	$(PYTHON) tools/verify_publish.py

# stage the Blender add-on as an installable zip (bundles crt_tpu)
blender-zip:
	$(PYTHON) tools/stage_blender_addon.py

# the PyTorch / CUDA port's add-on (bundles crt_tpu_torch, its kernel
# sources and native/*.cpp): crt_tpu_torch_blender.zip
blender-zip-torch:
	$(PYTHON) -m crt_tpu_torch.tools.stage_blender_addon

clean:
	rm -f native/libcrt_accel.so crt_tpu_blender.zip
	rm -rf .jax_cache results_tpu
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
