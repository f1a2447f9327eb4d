"""Checks of the engine against an independent model.

  conformance   the spec-differential gate (docs/CONFORMANCE.md): the
                engine's heartbeat and attack rounds walked beside the
                pure-numpy GossipSub v1.1 model of ops/spec.py, field by
                field, and the strict-JSON certificate `conform` prints.
"""
