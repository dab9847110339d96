"""Model building blocks the port needs so far: parameter initializers and
the MoE routing and capacity semantics (the rest of the model stack waits
for ROADMAP A11)."""
