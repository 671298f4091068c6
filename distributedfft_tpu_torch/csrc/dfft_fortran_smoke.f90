! dfft_fortran_smoke — a transform driven from Fortran, end to end.
!
! The run-one-smoke-from-Fortran proof for the binding module (the role
! of heFFTe's fortran test programs over its SWIG modules). Compiled with
! dfft_fortran.f90 into a shared library
! (distributedfft_tpu_torch.native.build_fortran()) and invoked from a
! Python-hosted process after distributedfft_tpu_torch.capi.install_c_api():
! the exported entry below plans, executes (forward + backward), and
! destroys a 3D C2C transform purely through the dfft module, computing
! the roundtrip error in Fortran (the reference driver's gate,
! 3dmpifft_opt/fftSpeed3d_c2c.cpp:85-91).
!
! Returns the relative roundtrip max error; negative codes mirror the C
! selftests (-1 bridge missing, -4 execution failure).

function dfft_fortran_smoke(nx, ny, nz) bind(c) result(err)
  use, intrinsic :: iso_c_binding
  use dfft
  implicit none

  integer(c_long_long), value :: nx, ny, nz
  real(c_double) :: err

  integer(c_long_long) :: n, i, fwd, bwd
  complex(c_float_complex), allocatable :: x(:), y(:), z(:)
  real(c_double) :: mx, d

  err = -1.0_c_double
  if (dfft_c_api_ready() == 0) return

  n = nx * ny * nz
  allocate(x(n), y(n), z(n))
  do i = 1, n
     ! the reference driver's ramp init (fftSpeed3d_c2c.cpp:61-63)
     x(i) = cmplx(real(mod(i, 97_c_long_long)) * 1.0e-2, &
                  real(mod(i, 89_c_long_long)) * (-1.0e-2), &
                  kind=c_float_complex)
  end do

  err = -4.0_c_double
  fwd = dfft_plan_c2c_3d(nx, ny, nz, DFFT_FORWARD)
  bwd = dfft_plan_c2c_3d(nx, ny, nz, DFFT_BACKWARD)
  if (fwd >= 0 .and. bwd >= 0) then
     if (dfft_execute_c2c(fwd, x, y) == 0 .and. &
         dfft_execute_c2c(bwd, y, z) == 0) then
        mx = 0.0_c_double
        err = 0.0_c_double
        do i = 1, n
           d = abs(real(z(i) - x(i), c_double))
           if (d > err) err = d
           d = abs(real(aimag(z(i) - x(i)), c_double))
           if (d > err) err = d
           d = abs(real(x(i), c_double))
           if (d > mx) mx = d
           d = abs(real(aimag(x(i)), c_double))
           if (d > mx) mx = d
        end do
        if (mx > 0.0_c_double) err = err / mx
     end if
  end if
  if (fwd >= 0) call dfft_destroy_plan_c(fwd)
  if (bwd >= 0) call dfft_destroy_plan_c(bwd)
  deallocate(x, y, z)
end function dfft_fortran_smoke

! The typed double tier driven from Fortran: z2z roundtrip through the
! dd engine, expected to meet the 1e-11 double gate (test_common.h:138).
function dfft_fortran_smoke_z2z(nx, ny, nz) bind(c) result(err)
  use, intrinsic :: iso_c_binding
  use dfft
  implicit none

  integer(c_long_long), value :: nx, ny, nz
  real(c_double) :: err

  err = -1.0_c_double
  if (dfft_c_api_ready() == 0) return
  err = dfft_c_selftest_z2z(nx, ny, nz)
end function dfft_fortran_smoke_z2z
