"""Compute ops for the MPPI solve: costs, rollouts, softmin, the noise stream
(``philox``) and the fused CUDA solve (``fused_solve``). Importing this
package builds no kernel."""
