"""The system under test for a traffic file with ``"program":
"bootstrap_filter"``: ``cusmc_tpu_torch``'s DLM and bootstrap filter,
built from the matrices the benchmark hands it and called as a user's
``run()`` calls it. One call of ``run`` is one request: a filter run over
the cell's observations, ending when its log-evidence and its ESS row
are on the host."""

from __future__ import annotations

import torch


class Program:
    """The filter of one cell on ``device``, its state in
    ``state_dtype`` (the traffic's, or bfloat16 for the control: the
    program's own mixed-precision path)."""

    def __init__(self, model: dict, ys, traffic: dict, device, state_dtype):
        from cusmc_tpu_torch.models.dlm import DLM
        from cusmc_tpu_torch.smc import particle_filter

        self.pf = particle_filter
        mats = {k: model[k] for k in ("F", "G", "m0", "C0", "V", "W")}
        self.model = DLM.create(noise=model["noise"], df=model["df"],
                                dtype=torch.float32, state_dtype=state_dtype,
                                device=device, **mats)
        self.ys = torch.as_tensor(ys, dtype=torch.float32, device=device)
        self.n = int(traffic["particles"])
        self.kwargs = dict(
            resampler=traffic["resampler"],
            resampler_kwargs=({"num_steps": traffic["num_sweeps"]}
                              if traffic["resampler"] == "metropolis"
                              else None),
            return_history=False,
            engine=traffic["engine"],
            pallas_tile=traffic.get("tile"))

    def run(self, key: int):
        """One request: ``(log_evidence, ess row)`` on the host."""
        out = self.pf.bootstrap_filter(key, self.model, self.ys, self.n,
                                       **self.kwargs)
        row = torch.cat([out.log_evidence.reshape(1), out.ess]).cpu()
        row = row.double().numpy()
        return float(row[0]), row[1:]
