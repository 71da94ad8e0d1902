# Single documented entry points for install / verify / benchmarks.
# ROADMAP.md's tier-1 command is `make test`.

PYTHON ?= python
export PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH))

.PHONY: install test test-fast test-port bench-smoke bench-serving \
	bench-autotune bench-distributed bench-decoding bench-telemetry

install:
	$(PYTHON) -m pip install -r requirements.txt

test:            ## tier-1 verify: the full suite, fail-fast
	$(PYTHON) -m pytest -x -q

test-fast:       ## kernel + core contracts only (minutes, not tens of)
	$(PYTHON) -m pytest -x -q tests/test_kernels.py tests/test_fused_mpgemm.py \
	    tests/test_lmma_dse.py tests/test_core_properties.py \
	    tests/test_autotune.py tests/test_autotune_properties.py \
	    tests/test_latency_regression.py tests/test_kvcache_paged.py \
	    tests/test_paged_serving.py

test-port:       ## PyTorch/CUDA port vs the JAX reference (CPU; card tests skip)
	$(PYTHON) -m pytest -q $(sort $(wildcard tests/test_torch_*.py))

bench-smoke:     ## quick analytic benchmark pass (no kernels executed)
	$(PYTHON) benchmarks/bench_fused_mpgemm.py --smoke
	$(PYTHON) benchmarks/roofline_table.py 2>/dev/null || true

bench-serving:   ## serving-engine perf (chunked vs per-tick decode) -> JSON
	$(PYTHON) benchmarks/bench_serving.py --out BENCH_serving.json

bench-autotune:  ## measured-time kernel tuner vs LMMA heuristic -> JSON
	$(PYTHON) benchmarks/bench_autotune.py --cache .tuning_cache.json \
		--out BENCH_autotune.json

bench-distributed: ## tensor-parallel sharded decode vs dense -> JSON
	$(PYTHON) benchmarks/bench_distributed.py --mesh 2x4 \
		--out BENCH_distributed.json

bench-decoding:  ## beam + bit-plane self-speculation vs greedy -> JSON
	$(PYTHON) benchmarks/bench_decoding.py --reduced \
		--assert-spec-speedup 1.0 --out BENCH_decoding.json

bench-telemetry: ## telemetry overhead gate (tracing-on >= 0.97x off) -> JSON
	$(PYTHON) benchmarks/bench_telemetry.py --assert-overhead 0.97 \
		--out BENCH_telemetry.json
