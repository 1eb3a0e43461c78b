"""The baselines the paper compares against come with ROADMAP A11; this
package holds, for now, the cohort engine they and ``ucfl`` share
(:mod:`repro_torch.core.baselines.common`)."""
