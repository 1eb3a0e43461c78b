"""The baselines the paper compares against come later (ROADMAP queue A); this
package holds, for now, the cohort engine they and ``ucfl`` share
(:mod:`repro_torch.core.baselines.common`)."""
