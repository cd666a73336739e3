"""Admission economics of the port: only :func:`price` so far.

Counterpart of ``akka_allreduce_tpu/serving/admission.py``; the scheduler
imports ``price`` to keep its running backlog. Tenant budgets, EDF
pricing and the overload controller are a later slice of the port.
"""

from __future__ import annotations


def price(req) -> int:
    """A request's token price: prompt (prefill work) plus the FULL
    decode budget — admission happens before anyone knows where the EOS
    lands, and a budget is what the tenant asked to reserve."""
    return len(req.prompt) + req.max_new_tokens
