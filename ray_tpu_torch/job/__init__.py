"""``ray_tpu_torch.job`` — job submission.

Role-equivalent of the reference's job-submission subsystem (ray
``python/ray/dashboard/modules/job/``): a ``JobSubmissionClient`` submits an
entrypoint shell command; a detached ``JobSupervisor`` actor runs it as a
subprocess, tracks status, captures logs, and can stop it.
"""

from .sdk import JobInfo, JobStatus, JobSubmissionClient  # noqa: F401
