"""Quickstart on the PyTorch port: the Parameter Service in 60 lines.

The control plane of ``repro_torch`` (pure Python; no tensor, so no
device): it prints what ``examples/quickstart.py`` prints, line for line.

1. Profile two training jobs (the paper's VGG19 + AlexNet testbed models).
2. Register them with the shared ParameterService -- watch the packing.
3. See the per-tensor placement an Agent would route by, and what happens
   on job exit (elastic recycle).

Run: PYTHONPATH=src python examples/torch_quickstart.py
"""

import argparse

from repro_torch.configs.paper_workloads import make_job
from repro_torch.core import ParameterService


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]
                            ).parse_args(argv)
    svc = ParameterService(total_budget=16, n_clusters=1, loss_limit=0.1)

    # A VGG19 job that would need 2 dedicated parameter servers under
    # ps-lite.
    vgg = make_job("vgg19", "vgg-0", n_servers=2, n_workers=2)
    svc.register_job(vgg)
    print(f"vgg-0 registered: {svc.n_aggregators} Aggregators "
          f"(ps-lite would use {vgg.required_servers})")

    # An AlexNet job arrives; AutoPS packs it into the same Aggregators.
    alex = make_job("alexnet", "alex-0", n_servers=2, n_workers=2)
    svc.register_job(alex)
    print(f"alex-0 packed:   {svc.n_aggregators} Aggregators "
          f"(ps-lite total would be "
          f"{vgg.required_servers + alex.required_servers})")
    print(f"CPU reduction ratio: {svc.cpu_reduction():.2f}")
    print(f"predicted per-job loss: "
          f"{ {k: round(v, 3) for k, v in svc.predicted_losses().items()} }")

    # The Agent mapping table (tensor -> Aggregator) for the AlexNet job.
    placement = svc.placement("alex-0")
    ids = sorted(set(placement.values()))
    print(f"alex-0 tensors spread over Aggregators: {ids}")

    # Job exit: Aggregators are recycled opportunistically.
    svc.job_exit("alex-0")
    print(f"alex-0 exited:   {svc.n_aggregators} Aggregators remain")
    print(f"utilizations: "
          f"{ {k: round(v, 2) for k, v in svc.utilizations().items()} }")


if __name__ == "__main__":
    main()
