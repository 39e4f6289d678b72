"""Rollout lifecycle state of the port: ``state.py`` only (the stages and
``GuardrailSpec`` that the control messages carry). The split, the
guardrail controller and staged rollouts themselves are not ported yet."""
