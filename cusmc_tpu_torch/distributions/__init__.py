"""Distributions of the PyTorch port (see ``cusmc_tpu.distributions``)."""

from cusmc_tpu_torch.distributions.base import (
    DISTRIBUTIONS,
    MVN,
    MVT,
    Distribution,
    make_distribution,
    register_distribution,
)
from cusmc_tpu_torch.distributions.mvn import (
    make_mvn_logprob,
    mvn_logpdf,
    mvn_logpdf_cov,
    mvn_sample,
    mvn_sample_cov,
)
from cusmc_tpu_torch.distributions.mvt import (
    make_mvt_logprob,
    mvt_logpdf,
    mvt_logpdf_cov,
    mvt_sample,
    mvt_sample_cov,
)

__all__ = [
    "DISTRIBUTIONS",
    "Distribution",
    "MVN",
    "MVT",
    "make_distribution",
    "register_distribution",
    "make_mvn_logprob",
    "mvn_logpdf",
    "mvn_logpdf_cov",
    "mvn_sample",
    "mvn_sample_cov",
    "make_mvt_logprob",
    "mvt_logpdf",
    "mvt_logpdf_cov",
    "mvt_sample",
    "mvt_sample_cov",
]
