from .wavefront import (  # noqa: F401
    RenderLoopState,
    assemble_gbuffer,
    current_image,
    generate_camera_rays_v,
    init_render_state,
    render,
    render_gbuffer_frame,
    trace_iteration,
)
