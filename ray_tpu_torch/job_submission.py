# Copied from ray_tpu/job_submission.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Job submission (reference: dashboard/modules/job/ —
JobSubmissionClient.submit_job sdk.py:39,129; JobManager job_manager.py:525
spawns a detached JobSupervisor actor :140 that runs the entrypoint shell
command, streams logs, retries).

The supervisor actor runs the entrypoint as a subprocess with
``RAY_TPU_TORCH_ADDRESS`` pointing at the cluster; status + logs live in the head
KV so any client (or the dashboard REST facade) can poll them.

As in the reference, ``ray_tpu_torch.init()`` with no address starts a new
local cluster and never reads ``RAY_TPU_TORCH_ADDRESS``: an entrypoint joins
the job's cluster with ``init(address=os.environ["RAY_TPU_TORCH_ADDRESS"])``.
The supervisor holds no GPU: the entrypoint drives the card through tasks,
actors or Serve. Its log is ``ray_tpu_torch_job_<id>.log`` under the
temporary directory (``tempfile.gettempdir()``).
"""

from __future__ import annotations

import enum
import json
import os
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch

_JOBS_NS = "_jobs"


class JobStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    def is_terminal(self) -> bool:
        return self in (JobStatus.SUCCEEDED, JobStatus.FAILED,
                        JobStatus.STOPPED)


class _JobSupervisor:
    """Detached-style actor driving one entrypoint subprocess."""

    def __init__(self, job_id: str, entrypoint: str,
                 runtime_env: Optional[Dict], metadata: Optional[Dict],
                 head_address: str):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.runtime_env = runtime_env or {}
        self.metadata = metadata or {}
        self.head_address = head_address
        self._proc = None
        self._stopped = False
        self._log_path = os.path.join(
            tempfile.gettempdir(), f"ray_tpu_torch_job_{job_id}.log")

    def _kv(self):
        from ray_tpu_torch._private import worker as worker_mod

        return worker_mod.global_worker.kv()

    def _set_status(self, status: str, message: str = "") -> None:
        self._kv().put(
            f"job::{self.job_id}".encode(),
            json.dumps({
                "job_id": self.job_id, "status": status,
                "message": message, "entrypoint": self.entrypoint,
                "metadata": self.metadata, "log_path": self._log_path,
                "time": time.time(),
            }).encode(), namespace=_JOBS_NS)

    def run(self) -> str:
        """Blocking: run the entrypoint to completion."""
        import subprocess

        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = self.head_address
        env["RAY_TPU_TORCH_JOB_ID"] = self.job_id
        env.update(self.runtime_env.get("env_vars", {}))
        cwd = self.runtime_env.get("working_dir") or os.getcwd()
        self._set_status(JobStatus.RUNNING)
        try:
            with open(self._log_path, "wb") as log:
                self._proc = subprocess.Popen(
                    self.entrypoint, shell=True, stdout=log,
                    stderr=subprocess.STDOUT, env=env, cwd=cwd,
                    start_new_session=True)
                # the entrypoint setsids into its own pgid: registering it
                # in the session pid registry is what lets teardown reap
                # it if this supervisor's worker dies mid-job
                session_dir = os.environ.get("RAY_TPU_TORCH_SESSION_DIR")
                if session_dir:
                    from ray_tpu_torch._private import lifecycle

                    lifecycle.register_process(
                        session_dir, "job", self._proc.pid,
                        os.environ.get("RAY_TPU_TORCH_NODE_ID", ""))
                code = self._proc.wait()
                if session_dir:
                    lifecycle.unregister_process(session_dir,
                                                 self._proc.pid)
            if self._stopped:
                # user-initiated stop: keep STOPPED, don't report FAILED
                return JobStatus.STOPPED
            if code == 0:
                self._set_status(JobStatus.SUCCEEDED)
                return JobStatus.SUCCEEDED
            self._set_status(JobStatus.FAILED,
                             f"entrypoint exited with code {code}")
            return JobStatus.FAILED
        except Exception as e:
            self._set_status(JobStatus.FAILED, repr(e))
            return JobStatus.FAILED

    def stop(self) -> bool:
        if self._proc is not None and self._proc.poll() is None:
            import signal

            self._stopped = True
            os.killpg(os.getpgid(self._proc.pid), signal.SIGTERM)
            self._set_status(JobStatus.STOPPED)
            return True
        return False

    def logs(self) -> str:
        if os.path.exists(self._log_path):
            with open(self._log_path, errors="replace") as f:
                return f.read()
        return ""


class JobSubmissionClient:
    """Reference: dashboard/modules/job/sdk.py:39."""

    def __init__(self, address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address)
        from ray_tpu_torch._private import worker as worker_mod

        self._w = worker_mod.global_worker
        node = ray_tpu_torch._global_node
        self._head_address = (
            f"{node.head_host}:{node.head_port}" if node else (address or ""))
        self._supervisors: Dict[str, Any] = {}

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[Dict] = None,
                   metadata: Optional[Dict] = None,
                   submission_id: Optional[str] = None) -> str:
        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:10]}"
        sup = ray_tpu_torch.remote(_JobSupervisor).options(
            name=f"_job_supervisor_{job_id}", namespace=_JOBS_NS,
            max_concurrency=4).remote(
                job_id, entrypoint, runtime_env, metadata,
                self._head_address)
        self._supervisors[job_id] = sup
        self._w.kv().put(
            f"job::{job_id}".encode(),
            json.dumps({"job_id": job_id, "status": JobStatus.PENDING,
                        "entrypoint": entrypoint,
                        "metadata": metadata or {},
                        "time": time.time()}).encode(),
            namespace=_JOBS_NS)
        sup.run.remote()  # fire and forget; status lands in KV
        return job_id

    def _info(self, job_id: str) -> Optional[Dict]:
        raw = self._w.kv().get(f"job::{job_id}".encode(),
                               namespace=_JOBS_NS)
        return json.loads(raw) if raw else None

    def get_job_status(self, job_id: str) -> Optional[JobStatus]:
        info = self._info(job_id)
        return JobStatus(info["status"]) if info else None

    def get_job_info(self, job_id: str) -> Optional[Dict]:
        return self._info(job_id)

    def get_job_logs(self, job_id: str) -> str:
        sup = self._get_supervisor(job_id)
        if sup is None:
            info = self._info(job_id)
            if info and info.get("log_path") and \
                    os.path.exists(info["log_path"]):
                with open(info["log_path"], errors="replace") as f:
                    return f.read()
            return ""
        return ray_tpu_torch.get(sup.logs.remote(), timeout=30)

    def _get_supervisor(self, job_id: str):
        sup = self._supervisors.get(job_id)
        if sup is None:
            try:
                sup = ray_tpu_torch.get_actor(f"_job_supervisor_{job_id}",
                                        namespace=_JOBS_NS)
            except Exception:
                return None
        return sup

    def stop_job(self, job_id: str) -> bool:
        sup = self._get_supervisor(job_id)
        if sup is None:
            return False
        return ray_tpu_torch.get(sup.stop.remote(), timeout=30)

    def list_jobs(self) -> List[Dict]:
        out = []
        for key in self._w.kv().keys(b"job::", namespace=_JOBS_NS):
            raw = self._w.kv().get(bytes(key), namespace=_JOBS_NS)
            if raw:
                out.append(json.loads(raw))
        return sorted(out, key=lambda j: j.get("time", 0))

    def wait_until_finish(self, job_id: str,
                          timeout_s: float = 300) -> JobStatus:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status is not None and status.is_terminal():
                return status
            time.sleep(0.25)
        raise TimeoutError(f"job {job_id} still running after {timeout_s}s")
