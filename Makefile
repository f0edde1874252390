# hullwhite_tpu — build & run targets (analogue of the reference makefile)

.PHONY: native test gpu-test smoke q1 q2 q3 benchmark all analyze bench clean cms \
        exotics notes g2pp swaption cap grid calibrate products

native:
	$(MAKE) -C native

test:
	python -m pytest tests/ -q

# on a machine with a GPU: the card lane, and the end-to-end smoke test
gpu-test:
	python -m pytest gpu_tests/ -q

smoke:
	python chip_smoke.py

q1:
	python -m hullwhite_tpu.cli q1

q2:
	python -m hullwhite_tpu.cli q2 --validate 20

q3:
	python -m hullwhite_tpu.cli q3 --validate 20

benchmark:
	python -m hullwhite_tpu.cli benchmark --sweep

all:
	python -m hullwhite_tpu.cli all

g2pp:
	python -m hullwhite_tpu.cli g2pp

swaption:
	python -m hullwhite_tpu.cli swaption --bermudan --delta --bermudan-sweep

calibrate:
	python -m hullwhite_tpu.cli calibrate

# every beyond-reference product surface in one go (after q1)
products: swaption cap cms exotics notes grid g2pp calibrate

cap:
	python -m hullwhite_tpu.cli cap

cms:
	python -m hullwhite_tpu.cli cms

exotics:
	python -m hullwhite_tpu.cli exotics

notes:
	python -m hullwhite_tpu.cli notes

grid:
	python -m hullwhite_tpu.cli grid

analyze:
	python -m hullwhite_tpu.analyze

bench:
	python bench.py

clean:
	rm -rf data plots
	$(MAKE) -C native clean
