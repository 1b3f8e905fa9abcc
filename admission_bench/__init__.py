"""The benchmark of ``policy_server_tpu_torch``: admission webhook traffic
against the port's server on one card, driven by ``BENCHMARK.json``.

Run a cell with ``python3 -m admission_bench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. The CPU tests are ``python -m pytest
admission_bench``; the card's, ``python -m pytest -m cuda admission_bench``
on a machine with one."""
