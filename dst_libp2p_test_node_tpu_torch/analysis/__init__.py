"""Checks of the engine against an independent model, and the tooling.

  conformance   the spec-differential gate (docs/CONFORMANCE.md): the
                engine's heartbeat and attack rounds walked beside the
                pure-numpy GossipSub v1.1 model of ops/spec.py, field by
                field, and the strict-JSON certificate `conform` prints.
  registry      the hot entry points' contracts (contracts.py): the
                reference's 20 single-device EntrypointContracts, and
                with rank pools its 6 mesh contracts, which `lint`
                (ast_lint.py, jaxpr_audit.py, report.py) and `microbench`
                (runtime/microbench.py) run.
  sharding_audit
                the GA-S rules over what a contract's ranks did (their
                collectives, the windows' placement, their peak memory)
                and the rung predictor (`lint --sharding`,
                `--predict-rung`).
"""
